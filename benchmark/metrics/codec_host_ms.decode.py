"""codec_host_ms.decode: host ms a decode tick spends in the packet
decoder's own code (`LPCNetDecoder.decode`, unpacking, the packets'
features, the warm-up masks): the self times of the `lpcnet.codec.decode`,
`.unpack`, `.features` and `.warmup_mask` spans, mean a tick over the
traced stretch."""

from benchmark.yardstick.spans import span_means

NAMES = ("lpcnet.codec.decode", "lpcnet.codec.unpack",
         "lpcnet.codec.features", "lpcnet.codec.warmup_mask")


def read(ctx):
    m = span_means(ctx)
    return None if m is None else m.sum_self(*NAMES)
