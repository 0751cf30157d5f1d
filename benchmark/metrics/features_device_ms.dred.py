"""features_device_ms.dred: device ms a DRED tick spends in the
encoder-side analysis of its two 10 ms frames: the time between the
`lpcnet.dred.features` span's two events on the pool's stream, mean a tick
over the traced stretch."""

from benchmark.yardstick.spans import span_means


def read(ctx):
    m = span_means(ctx)
    return None if m is None else m.device_ms.get("lpcnet.dred.features")
