"""device_idle.dred: the share of the traced stretch of DRED encoding ticks
in which no operation ran on the device, from the union of the profiler's
device intervals (%)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
