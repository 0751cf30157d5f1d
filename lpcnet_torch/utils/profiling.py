"""Profiling and observability: the counterpart of
`lpcnet_tpu/utils/profiling.py`.

* ``trace``          -- context manager around `torch.profiler` that writes a
                        Chrome trace (Perfetto, chrome://tracing) to `logdir`.
* ``time_fn``        -- median / min wall time of a callable, synchronising
                        the card after each call.
* ``MetricsLogger``  -- append-only JSONL sink for training curves; its
                        `log_async` keeps device scalars unfetched until
                        `flush_async`, so a training loop never waits for the
                        card at every step.
* ``device_memory_stats`` -- `torch.cuda.memory_stats` of the current card,
                        None without CUDA.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, host: bool = False):
    """Record the CUDA activity (and the host's with `host`) of the block
    with `torch.profiler`, and write it to `logdir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 3, iters: int = 10,
            **kwargs) -> Dict[str, float]:
    """Median/min wall time of fn(*args) with a device synchronise."""
    def run():
        out = fn(*args, **kwargs)
        _sync()
        return out

    for _ in range(warmup):
        run()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    times.sort()
    return {"median_s": times[len(times) // 2], "min_s": times[0],
            "mean_s": sum(times) / len(times), "iters": iters}


def _value(v):
    return float(v) if hasattr(v, "__float__") else v


class MetricsLogger:
    """Append-only JSONL metrics log (training curves, bench history)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")
        self._pending = []

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"ts": time.time(), "step": step}
        rec.update({k: _value(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_async(self, step: int, **metrics: Any) -> None:
        """Queue a record holding device scalars without fetching them: a
        fetch every step makes the host wait for the card. Call
        flush_async() at log intervals to write the queued records."""
        self._pending.append((time.time(), step, metrics))

    def flush_async(self) -> None:
        for ts, step, metrics in self._pending:
            rec = {"ts": ts, "step": step}
            rec.update({k: _value(v) for k, v in metrics.items()})
            self._f.write(json.dumps(rec) + "\n")
        self._pending = []
        self._f.flush()

    def close(self):
        self.flush_async()
        self._f.close()


def device_memory_stats() -> Optional[Dict[str, int]]:
    """The current card's allocator statistics; None without CUDA."""
    if not torch.cuda.is_available():
        return None
    return dict(torch.cuda.memory_stats())
