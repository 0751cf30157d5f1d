"""serving_host_ms.decode: host ms a decode tick spends in
`StreamPool.step_packets` outside the decoder (the gather of the packets,
the attach lookups, the scatter of the audio): the self time of the
`lpcnet.serving.step_packets` span, mean a tick over the traced stretch."""

from benchmark.yardstick.spans import span_means


def read(ctx):
    m = span_means(ctx)
    return None if m is None else m.self_ms.get("lpcnet.serving.step_packets")
