"""k1_roofline.decode: the free-running sample loop's (K1's) least time a
launch at the cell's streams and 160 steps, in the configuration's GRU
type (`yardstick.bounds.k1_bound_ms`), over the mean device time of the
traced `masked_loop_kernel` launches (%). Nothing to read where none
launched."""

from benchmark.yardstick.bounds import k1_bound_ms


def read(ctx):
    ms, n = ctx.trace.device_ms("masked_loop_kernel")
    if n == 0 or ms <= 0:
        return None
    c = ctx.config
    bound, _ = k1_bound_ms(c["rnn_units1"], c["rnn_units2"],
                           c["numerics"]["serve_gru_type"],
                           ctx.facts["streams"], c["frame_size"])
    return 100.0 * bound / (ms / n)
