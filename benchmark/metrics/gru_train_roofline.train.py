"""gru_train_roofline.train: the GRU training kernels' (K5's) least time a
step, forward and backward at both GRU widths (`yardstick.bounds.
k5_bound_ms`), over their device time a step in the traced stretch (%).
Nothing to read where none launched."""

from benchmark.yardstick.bounds import k5_bound_ms

K5 = ("gru_fwd_chain_kernel", "gru_fwd_warp_kernel", "gru_fwd_kernel",
      "gate_pass_kernel", "gru_bwd_chain_kernel", "dwr_kernel",
      "reduce_parts_kernel")


def read(ctx):
    ms, n = ctx.trace.device_ms(*K5)
    steps = ctx.facts["traced_steps"]
    if n == 0 or ms <= 0 or steps <= 0:
        return None
    c, f = ctx.config, ctx.facts
    t = f["chunk_frames"] * c["frame_size"]
    bound = sum(k5_bound_ms(u, f["batch"], t, bwd)[0]
                for u in (c["rnn_units1"], c["rnn_units2"]) for bwd in (False, True))
    return 100.0 * bound / (ms / steps)
