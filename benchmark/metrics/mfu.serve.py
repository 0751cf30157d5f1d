"""mfu.serve: the least device time of the window's model arithmetic, which
the runner counts with `yardstick.work` from the cell's shapes and inputs,
over the window's time (%)."""


def read(ctx):
    f = ctx.facts
    if f["window_s"] <= 0 or f.get("least_compute_s", 0) <= 0:
        return None
    return 100.0 * f["least_compute_s"] / f["window_s"]
