"""device_idle.dred_dec: the share of the traced stretch of DRED decoding
ticks in which no operation ran on the device, from the union of the
profiler's device intervals (%)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
