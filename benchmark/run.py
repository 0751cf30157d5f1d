"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and inputs from the seed, the program built, every shape
the cell's traffic uses warmed up) is timed from the start of this process
to the first timed tick or step (`setup_s`). The window then runs for
`--seconds`. With `--trace 1` a stretch after the window runs under
`torch.profiler`, and the per-layer metrics are printed in place of the
end-to-end ones. Once the window has closed and the peak memory is read,
the program is freed and the reference judges what the window produced.
The last line of standard output is the result as one JSON object; the
numbers compared, each beside its limit, end standard error and the
result's "checks".
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# one process with one host thread of its own: the host path is Python
# dispatching small launches, and a pool of spinning threads only adds noise
os.environ.setdefault("OMP_NUM_THREADS", "1")

import torch  # noqa: E402

from benchmark import harness as H  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    bench = H.load_benchmark()
    cell = H.find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{cell['chips']} GPUs asked for, "
                    f"{torch.cuda.device_count()} present")
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = H.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), T_START, bench)
    found = H.forbidden_modules()
    if found:
        return fail("loaded after the window: " + ", ".join(found))
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
