"""sample_loop_ms.plc: device ms a tick in the sample-loop kernels (K2 and
K3, `masked_loop_kernel` by name) over the traced stretch of concealment
ticks; 0 where none launched."""


def read(ctx):
    ticks = ctx.facts["traced_ticks"]
    if ticks <= 0:
        return None
    ms, _ = ctx.trace.device_ms("masked_loop_kernel")
    return ms / ticks
