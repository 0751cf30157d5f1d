"""The program's spans of a traced stretch (`lpcnet_torch.utils.profiling.
span`), reduced to means a root span (a tick or a step): by name, the self
host ms, the host ms and the device ms, each summed over the name's spans
and divided by the number of roots.

A span's self time is its host time less the part of its interval that its
child spans cover. Taking the spans empties the program's buffer, so every
reader of a run shares one reduction, kept on the reader context. A
program without spans, or a stretch in which none was recorded, gives None.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

KEY = "span_means"


@dataclass
class SpanMeans:
    roots: int
    self_ms: Dict[str, float]
    host_ms: Dict[str, float]
    device_ms: Dict[str, float]     # names whose spans timed the device

    def sum_self(self, *names: str) -> Optional[float]:
        """The summed self ms a root of the names that were recorded; None
        where none was."""
        hits = [self.self_ms[n] for n in names if n in self.self_ms]
        return sum(hits) if hits else None


def _covered_ns(start: int, end: int, children) -> int:
    """The length of the union of the children's intervals inside
    [start, end]."""
    total, reach = 0, start
    for s, e in sorted(children):
        s, e = max(s, reach), min(e, end)
        if e > s:
            total += e - s
            reach = e
    return total


def reduce(records) -> Optional[SpanMeans]:
    """Means a root of records with the fields of `SpanRecord` (`name`,
    `root`, `parent`, `start_ns`, `end_ns`, `device_ms`)."""
    roots = {r.root for r in records if r.parent is None}
    if not roots:
        return None
    children = {}
    for r in records:
        if r.parent is not None:
            children.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
    self_ns: Dict[str, float] = {}
    host_ns: Dict[str, float] = {}
    dev_ms: Dict[str, float] = {}
    for i, r in enumerate(records):
        host = r.end_ns - r.start_ns
        own = host - _covered_ns(r.start_ns, r.end_ns, children.get(i, ()))
        host_ns[r.name] = host_ns.get(r.name, 0) + host
        self_ns[r.name] = self_ns.get(r.name, 0) + own
        if r.device_ms is not None:
            dev_ms[r.name] = dev_ms.get(r.name, 0.0) + r.device_ms
    n = len(roots)
    return SpanMeans(roots=n,
                     self_ms={k: v / 1e6 / n for k, v in self_ns.items()},
                     host_ms={k: v / 1e6 / n for k, v in host_ns.items()},
                     device_ms={k: v / n for k, v in dev_ms.items()})


def _program_spans() -> list:
    from lpcnet_torch.utils import profiling
    take = getattr(profiling, "take_spans", None)
    return take() if take is not None else []


def span_means(ctx) -> Optional[SpanMeans]:
    """The run's reduction: taken from the program once, then read from
    `ctx`."""
    if not hasattr(ctx, KEY):
        setattr(ctx, KEY, reduce(_program_spans()))
    return getattr(ctx, KEY)
