"""mfu.dred_dec: the least device time of the window's DRED decoding (every
stream's decoder initialisation and decoder steps over its payload's
latents, counted by `yardstick/work_dred_dec.py` at float32's peak) over
the window's time (%)."""


def read(ctx):
    f = ctx.facts
    if f["window_s"] <= 0 or f.get("least_compute_s", 0) <= 0:
        return None
    return 100.0 * f["least_compute_s"] / f["window_s"]
