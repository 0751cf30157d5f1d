"""mfu.dred: the least device time of the window's DRED arithmetic (the
encoder-side analysis and the RDO-VAE encoder step of every stream, counted
by `yardstick/work_dred.py` at float32's peak) over the window's time (%)."""


def read(ctx):
    f = ctx.facts
    if f["window_s"] <= 0 or f.get("least_compute_s", 0) <= 0:
        return None
    return 100.0 * f["least_compute_s"] / f["window_s"]
