"""plc_compacted_share: of the concealment frames the program stepped, the
share whose sample-rate section ran on the compacted sub-batch
(`BatchedPLC.stats`, a program counter, over the whole run) (%)."""


def read(ctx):
    s = ctx.counters
    total = s.get("compacted", 0) + s.get("overflowed", 0) + s.get("full", 0)
    if total == 0:
        return None
    return 100.0 * s["compacted"] / total
