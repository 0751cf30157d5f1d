"""Observability of the port: spans at its layer boundaries, the
operator's trace exporter and the training metrics log (the counterpart of
`lpcnet_tpu/utils/profiling.py`, with spans of its own).

* ``span``           -- a context manager at a layer boundary of the program
                        (a decode tick and its phases, a training step and
                        its phases). While no `torch.profiler` records it is
                        one shared no-op behind a single check of the
                        profiler's state. While one records, it enters
                        `torch.profiler.record_function(name)`, so the span
                        stands nested in the profiler's trace on the clock
                        of the device's activity, and it keeps a record in
                        memory (`SpanRecord`).
* ``take_spans``     -- the records kept so far, their device times
                        resolved; empties the buffer.
* ``trace``          -- the operator's exporter: `torch.profiler` around a
                        block, written to `logdir/trace.json` as a Chrome
                        trace (Perfetto, chrome://tracing) of the spans over
                        the kernels they launched.
* ``MetricsLogger``  -- append-only JSONL sink for training curves; its
                        `log_async` keeps device scalars unfetched until
                        `flush_async`, so a training loop never waits for the
                        card at every step.

Spans are on exactly while a torch profiler records: no switch and no
environment variable. The buffer is the process's, as the profiler is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, List, Optional

import torch


# a root opening with this many records kept is not kept, nor its spans:
# the profiler's trace still holds them (a long `trace` of training)
MAX_SPANS = 1 << 17
_DROPPED = -1


@dataclasses.dataclass
class SpanRecord:
    """One span: `root` is the id of its root span (one decode tick or one
    training step), `parent` the index of its parent among the records
    taken with it (None for a root), the host interval is
    `time.perf_counter_ns()` inside the profiler's range, and `device_ms`
    is the time between the span's two events on its device's stream
    (None for a host-only span)."""
    name: str
    root: int
    parent: Optional[int]
    start_ns: int
    end_ns: int = 0
    device_ms: Optional[float] = None


class _Buffer:
    def __init__(self):
        self.records: List[SpanRecord] = []
        self.events = {}            # record index -> (stream, start, end)
        self.roots = 0
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "open", None)
        if st is None:
            st = self.local.open = []
        return st

    def open(self, name: str, stream) -> int:
        st = self.stack()
        with self.lock:
            if (st[-1] == _DROPPED if st else len(self.records) >= MAX_SPANS):
                i = _DROPPED
            else:
                if st:
                    parent, root = st[-1], self.records[st[-1]].root
                else:
                    parent, root = None, self.roots
                    self.roots += 1
                i = len(self.records)
                self.records.append(SpanRecord(name, root, parent,
                                               time.perf_counter_ns()))
        if i != _DROPPED and stream is not None:
            ev = (stream, torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[1].record(stream)
            self.events[i] = ev
        st.append(i)
        return i

    def close(self, i: int) -> None:
        self.stack().pop()
        if i == _DROPPED:
            return
        ev = self.events.get(i)
        if ev is not None:
            ev[2].record(ev[0])
        self.records[i].end_ns = time.perf_counter_ns()

    def take(self) -> List[SpanRecord]:
        if self.stack():
            raise RuntimeError("take_spans() inside an open span")
        records, events = self.records, self.events
        self.records, self.events = [], {}
        for i, (_, start, end) in events.items():
            end.synchronize()
            records[i].device_ms = start.elapsed_time(end)
        return records


_BUFFER = _Buffer()


def _stream(device):
    """The CUDA stream a span's events time: the current stream of `device`
    (True: of the current CUDA device); None for a host-only span."""
    if device is True:
        return torch.cuda.current_stream()
    if isinstance(device, torch.device) and device.type == "cuda":
        return torch.cuda.current_stream(device)
    return None


class _Span:
    __slots__ = ("name", "device", "rf", "index")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.index = _BUFFER.open(self.name, _stream(self.device))
        return self

    def __exit__(self, *exc):
        _BUFFER.close(self.index)
        self.rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device=False):
    """A span named `name` around a `with` block. `device` (a torch.device,
    or True for the current CUDA device) also times on that device's
    current stream the work the block enqueues; a CPU device or False
    times the host only. A no-op unless a torch profiler records."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, device)


def take_spans() -> List[SpanRecord]:
    """The spans recorded since the last take, in the order they opened,
    with their device times resolved (a wait for their events); empties
    the buffer. Call it with no span open."""
    return _BUFFER.take()


@contextlib.contextmanager
def trace(logdir: str):
    """Record the block with `torch.profiler`, the host's activity (spans
    included) and the card's where there is one, and write it to
    `logdir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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

