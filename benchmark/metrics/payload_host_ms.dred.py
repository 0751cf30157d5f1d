"""payload_host_ms.dred: host ms a DRED tick spends making its payloads
outside the readback: the host times of the `lpcnet.dred.quantize`,
`lpcnet.dred.pvq` and `lpcnet.dred.entropy` spans (the symbols' launches,
the PVQ search's launches, the native framing call), summed, mean a tick
over the traced stretch."""

from benchmark.yardstick.spans import span_means

NAMES = ("lpcnet.dred.quantize", "lpcnet.dred.pvq", "lpcnet.dred.entropy")


def read(ctx):
    m = span_means(ctx)
    if m is None:
        return None
    hits = [m.host_ms[n] for n in NAMES if n in m.host_ms]
    return sum(hits) if hits else None
