"""The benchmark of `lpcnet_torch` on NVIDIA GPUs.

One command runs one cell (a model configuration under a traffic mix) once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the root of the repository names the cells and metrics;
everything that belongs to one configuration, traffic mix or per-layer
metric lies in files of its own here, found by name:

- `configs/<config>.json`: the configuration's sizes, numerics and source;
- `traffic/<mix>.json`: a traffic mix's parameters, read by `generate.py`,
  and the runner (`runners/<runner>.py`) that runs the system on it;
- `metrics/<metric>.py`: the reader of one per-layer metric;
- `reference/`: the plain references the outputs are judged by;
- `yardstick/`: peaks, roofline and work counts, and the trace reduction.

Nothing here imports JAX or the JAX package.
"""
