"""Finds what `BENCHMARK.json` names, by name, in the benchmark's own files,
and runs one cell once.

- a workload's configuration: `configs/<config>.json`; its reference:
  `reference/<the file's "reference">.py`;
- its traffic mix: `traffic/<traffic>.json`, whose "runner" names
  `runners/<runner>.py`;
- a per-layer metric: `metrics/<metric>.py`, whose `read(ctx)` returns the
  value or None where it finds nothing to read.

A later cell, mix or metric is new files and new entries: no file here
changes.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from .generate import sub_seed

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lpcnet_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind} file {path}")
    with open(path) as f:
        return json.load(f)


def reference_module(config: dict):
    return importlib.import_module(f"benchmark.reference.{config['reference']}")


def runner_module(traffic: dict):
    return importlib.import_module(f"benchmark.runners.{traffic['runner']}")


def metric_reader(name: str, base: Path = HERE):
    """`metrics/<name>.py` loaded by path (a metric's name may hold dots)."""
    path = base / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no reader {path} for metric {name}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, section: str) -> list:
    """The `section` metrics ("end_to_end" or "per_layer") this cell
    reports: those that list it, or list no cells at all."""
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def build(workload: str, seed: int, device, bench: dict | None = None,
          traffic_overrides: dict | None = None, base: Path = HERE):
    """(the cell's entry, its runner, built but not set up). `base` is the
    folder the configuration and traffic files are read from."""
    bench = bench or load_benchmark(base.parent)
    cell = find(bench["workloads"], workload, "workload")
    config = load_json("configs", cell["config"], base)
    traffic = dict(load_json("traffic", cell["traffic"], base),
                   **(traffic_overrides or {}))
    runner = runner_module(traffic).Runner(config, traffic, seed, device,
                                        reference_module(config))
    return cell, runner


def per_layer_context(runner, trace) -> types.SimpleNamespace:
    return types.SimpleNamespace(trace=trace, facts=runner.facts(),
                                 counters=runner.counters(), config=runner.c,
                                 traffic=runner.traffic)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, bench: dict | None = None,
             traffic_overrides: dict | None = None, plant=None,
             base: Path = HERE) -> dict:
    """Set up, warm up and run one cell, trace a stretch if asked, free the
    program and judge the window's outputs. Returns the result object
    (its "checks" last). `plant(runner)`, called before set-up, lets a
    test break the timed path underneath."""
    bench = bench or load_benchmark(base.parent)
    cell, runner = build(workload, seed, device, bench, traffic_overrides, base)
    if plant is not None:
        plant(runner)
    runner.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # what set-up made lives to the end: out of the collector's way
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    rs = np.random.Generator(np.random.PCG64(sub_seed(seed, 9)))
    e2e = runner.window(seconds, rs)
    e2e["setup_s"] = setup_s
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    out = {}
    metrics = {}
    if trace:
        from .yardstick.trace import profiled
        tr = profiled(runner.stretch())
        ctx = per_layer_context(runner, tr)
        for m in cell_metrics(bench, workload, "per_layer"):
            value = metric_reader(m["name"], base)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
    else:
        for m in cell_metrics(bench, workload, "end_to_end"):
            if m["name"] not in e2e:
                raise RuntimeError(f"the runner measured no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    attempted = e2e["units"] * getattr(runner, "streams", 1)

    runner.free()
    gc.unfreeze()
    limits = runner.traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in runner.check().items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    return dict({"correct": correct, "attempted": attempted, "failed": 0,
                 "metrics": metrics, "device": dev}, **out, checks=checks)
