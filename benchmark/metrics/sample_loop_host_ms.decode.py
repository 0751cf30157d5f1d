"""sample_loop_host_ms.decode: host ms a decode tick spends on the sample
loop's launch path (the wrapper's argument preparation and its four
launches): the host time of the `lpcnet.kernels.sample_loop` spans, mean a
tick over the traced stretch. The kernel's device time is
`k1_roofline.decode`'s."""

from benchmark.yardstick.spans import span_means


def read(ctx):
    m = span_means(ctx)
    return None if m is None else m.host_ms.get("lpcnet.kernels.sample_loop")
