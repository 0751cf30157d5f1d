"""readback_wait_ms.decode: host ms a decode tick waits for the device to
drain its queue before the audio reaches the host: the host time of the
`lpcnet.codec.readback` span, mean a tick over the traced stretch."""

from benchmark.yardstick.spans import span_means


def read(ctx):
    m = span_means(ctx)
    return None if m is None else m.host_ms.get("lpcnet.codec.readback")
