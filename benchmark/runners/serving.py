"""The closed-loop serving window shared by the pool runners.

The pool is the one caller: it steps back to back, with every stream's
input ready when a tick starts. A tick is timed on the host's clock from
the inputs handed to the pool to the audio on the host. Before some ticks
(the first, and those that start after fractions of the window drawn from
the seed) the program's state is copied, and after them again, so that the
reference can replay those ticks from the program's own state.
"""

from __future__ import annotations

import math
import time

import numpy as np


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


class ServeRunner:
    """Subclasses give `inputs(i)` (the tick's inputs, built outside the
    tick), `step(inputs)` (the timed call into the pool; returns
    {stream: audio}), `snapshot()` (a copy of the program's state),
    `rows(by_stream)` (a {stream: array} dict as one array in slot order)
    and `tick_audio_s`, `streams`. `records` holds (tick, state before,
    inputs, outputs, state after) of the ticks the reference replays."""

    next_tick = 0

    def window(self, seconds: float, rs: np.random.Generator) -> dict:
        pending = sorted(rs.uniform(0.05, 0.95, self.traffic["check_ticks"] - 1))
        times, self.records = [], []
        first = self.next_tick
        start = time.perf_counter()
        while True:
            i = self.next_tick
            take = i == first or (pending and time.perf_counter() - start
                                  >= pending[0] * seconds)
            if take:
                if i != first:
                    pending.pop(0)
                before = self.snapshot()
            inp = self.inputs(i)
            t0 = time.perf_counter()
            out = self.step(inp)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            if take:
                self.records.append((i, before, self.rows(inp),
                                     self.rows(out), self.snapshot()))
            self.next_tick += 1
            if t1 - start >= seconds:
                break
        wall = time.perf_counter() - start
        self.window_ticks = (first, self.next_tick)
        self.window_s = wall
        return {"audio_s_per_s": self.streams * self.tick_audio_s * len(times) / wall,
                "tick_ms_p95": 1e3 * percentile(times, 95.0),
                "units": len(times)}

    def stretch(self):
        """The traced stretch: `trace_ticks` more ticks."""
        n = self.traffic["trace_ticks"]
        self.traced_ticks = (self.next_tick, self.next_tick + n)

        def run():
            for _ in range(n):
                self.step(self.inputs(self.next_tick))
                self.next_tick += 1
        return run
