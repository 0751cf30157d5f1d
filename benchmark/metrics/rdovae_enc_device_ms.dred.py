"""rdovae_enc_device_ms.dred: device ms a DRED tick spends in the RDO-VAE's
streaming encoder step: the time between the `lpcnet.dred.encode` span's
two events on the encoder's stream, mean a tick over the traced stretch."""

from benchmark.yardstick.spans import span_means


def read(ctx):
    m = span_means(ctx)
    return None if m is None else m.device_ms.get("lpcnet.dred.encode")
