"""frame_net_host_ms.decode: host ms a decode tick spends in the frame
network (its four calls): the host time of the
`lpcnet.model.frame_network` spans, mean a tick over the traced
stretch."""

from benchmark.yardstick.spans import span_means


def read(ctx):
    m = span_means(ctx)
    return None if m is None else m.host_ms.get("lpcnet.model.frame_network")
