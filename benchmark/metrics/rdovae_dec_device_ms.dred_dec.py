"""rdovae_dec_device_ms.dred_dec: device ms a DRED decoding tick spends in
the RDO-VAE's decoder: the time between the `lpcnet.dred.decode` span's
two events on the decoder's stream (the unquantisation, the decoder's
initialisation and its steps over every latent), mean a tick over the
traced stretch."""

from benchmark.yardstick.spans import span_means


def read(ctx):
    m = span_means(ctx)
    return None if m is None else m.device_ms.get("lpcnet.dred.decode")
