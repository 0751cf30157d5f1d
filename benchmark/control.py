"""Run a cell's control on the card: the reference in the nearest lower
precision put in the program's place (serving: 4-bit GRU matrices; training:
float8 GRU operands), at the cell's own size, judged as a run is judged.
Each seed prints its numbers beside the cell's limits; the control has to
come out not correct.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 [--ticks 4]

With `--fault <name>` (`faults.py`) it runs the cell itself instead, with
that fault planted under the timed path and a `--seconds` window, and
prints the numbers it reads. The benchmark's own runs never run either.
`tests/test_bench_controls.py` runs the controls as a test on the card.
"""

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time  # noqa: E402

import torch  # noqa: E402

from benchmark import faults as F  # noqa: E402
from benchmark import harness as H  # noqa: E402


def control(workload: str, seed: int, ticks: int, device) -> dict:
    cell, runner = H.build(workload, seed, device)
    numbers = runner.control("fp8") if runner.traffic["runner"] == "train" else runner.control(ticks)
    limits = runner.traffic["limits"]
    return {"seed": seed, "numbers": numbers,
            "correct": all(v <= limits[k] for k, v in numbers.items()),
            "limits": limits}


def with_fault(workload: str, seed: int, fault: str, seconds: float,
               device) -> dict:
    plant = {**F.SERVING, **F.TRAINING}[fault]
    res = H.run_cell(workload, seed, seconds, False, device, time.perf_counter(),
                     plant=plant)
    return {"seed": seed, "fault": fault, "correct": res["correct"],
            "numbers": {k: v["value"] for k, v in res["checks"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--fault", choices=sorted({**F.SERVING, **F.TRAINING}))
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        out = (with_fault(args.workload, seed, args.fault, args.seconds, dev)
               if args.fault else control(args.workload, seed, args.ticks, dev))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
