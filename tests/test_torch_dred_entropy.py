"""DRED entropy coding in the port (`lpcnet_torch.dred.entropy`): the cases
of test_dred_entropy.py on the port's copy of the host coder, and its bytes,
indices and fixed-point tables against the JAX package's."""

import jax
import numpy as np
import pytest
import torch

from lpcnet_tpu.dred import entropy as JE
from lpcnet_tpu.models import rdovae as JR

from lpcnet_torch import api
from lpcnet_torch.dred import entropy as E
from lpcnet_torch.models import rdovae as RV
from lpcnet_torch.weights.convert import params_to_torch

torch.set_num_threads(1)

SMALL = dict(cond_size=32, cond_size2=32, latent_dim=20, state_dim=8,
             pvq_num_pulses=20)


def _model_symbols(rng, n):
    """Symbols drawn roughly from the Laplace model itself."""
    p0 = rng.randint(1000, 32000, n).astype(np.uint16)
    r = rng.randint(1000, 32000, n).astype(np.uint16)
    z = np.where(rng.rand(n) < p0 / 32768.0, 0,
                 np.minimum(rng.geometric(np.maximum(1e-4, 1 - r / 32768.0)),
                            E.MAX_MAG) * rng.choice([-1, 1], n)).astype(np.int32)
    return z, p0, r


def test_range_coder_roundtrip_and_jax_bytes():
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2, 4000)
    probs = rng.randint(1, 32767, 4000)
    enc, jenc = E.RangeEncoder(), JE.RangeEncoder()
    for b, p in zip(bits, probs):
        enc.encode_bit(int(b), int(p))
        jenc.encode_bit(int(b), int(p))
    data = enc.finish()
    assert data == jenc.finish()
    dec = E.RangeDecoder(data)
    assert np.array_equal(bits, [dec.decode_bit(int(p)) for p in probs])
    raw = E.RangeEncoder()
    raw.encode_bits_raw(0x2A5, 10)
    assert E.RangeDecoder(raw.finish()).decode_bits_raw(10) == 0x2A5


def test_latent_rate_matches_model_estimate():
    """Achieved bytes ~= the hard_rate_estimate that the loss optimizes;
    the bytes equal the JAX package's Python coder's."""
    rng = np.random.RandomState(3)
    z, p0, r = _model_symbols(rng, 4000)
    enc = E.RangeEncoder()
    E.encode_latents(enc, z, p0, r)
    data = enc.finish()
    jenc = JE.RangeEncoder()
    JE.encode_latents(jenc, z, p0, r)
    assert data == jenc.finish()
    p0f, rf = p0 / 32768.0, r / 32768.0
    mag = np.abs(z)
    bits = np.where(mag == 0, -np.log2(p0f),
                    -np.log2(0.5 * (1 - p0f) * (1 - rf) * rf ** (mag - 1)))
    assert abs(len(data) - bits.sum() / 8) < 16
    assert np.array_equal(z, E.decode_latents(E.RangeDecoder(data), p0, r))


def test_pvq_index_bijective_small():
    def gen(n, k):
        if n == 0:
            if k == 0:
                yield ()
            return
        for v in range(-k, k + 1):
            for rest in gen(n - 1, k - abs(v)):
                yield (v,) + rest

    n, k = 4, 3
    vecs = [v for v in gen(n, k) if sum(abs(x) for x in v) == k]
    assert len(vecs) == RV.pvq_codebook_size(n, k)
    seen = set()
    for v in vecs:
        idx = E.pvq_encode_index(v, k)
        assert 0 <= idx < RV.pvq_codebook_size(n, k) and idx not in seen
        assert idx == JE.pvq_encode_index(v, k)
        seen.add(idx)
        assert tuple(E.pvq_decode_index(idx, n, k)) == v
    assert E.pvq_index_bits(24, 82) == JE.pvq_index_bits(24, 82)


def test_pvq_search_properties_and_jax():
    rng = np.random.RandomState(11)
    for _ in range(10):
        x = rng.randn(24)
        y = E.pvq_search(x, 82)
        assert np.array_equal(y, JE.pvq_search(x, 82))
        assert np.abs(y).sum() == 82
        cos = (x @ y) / (np.linalg.norm(x) * np.linalg.norm(y))
        assert cos > 0.98
        idx = E.pvq_encode_index(y, 82)
        assert idx == JE.pvq_encode_index(y, 82)
        assert np.array_equal(y, E.pvq_decode_index(idx, 24, 82))
        assert np.array_equal(E.pvq_normalize(y), JE.pvq_normalize(y))


def test_payload_bytes_equal_jax():
    """encode_payload gives the JAX package's bytes for the same symbols,
    pulses and tables, and decode_payload inverts it."""
    rng = np.random.RandomState(4)
    jcfg = JR.RDOVAEConfig(**SMALL)
    table = (0.5 * rng.randn(jcfg.quant_levels, 6 * jcfg.latent_dim)
             ).astype(np.float32)
    jp = JR.init_params(jax.random.PRNGKey(0), jcfg)
    jp["statistical_model"]["quant_embedding"]["table"] = table
    stats = JE.stats_fixed_point(jp, jcfg)
    for n_lat, q0, q1 in ((6, 3, 9), (1, 5, 5), (26, 9, 15)):
        zq = np.clip(np.round(rng.laplace(0, 2, (n_lat, jcfg.latent_dim))),
                     -E.MAX_MAG, E.MAX_MAG).astype(np.int32)
        pulses = E.pvq_search(rng.randn(jcfg.state_dim), jcfg.pvq_num_pulses)
        got = E.encode_payload(zq, pulses, q0, q1, stats, jcfg.pvq_num_pulses)
        assert got == JE.encode_payload(zq, pulses, q0, q1, stats,
                                        jcfg.pvq_num_pulses)
        zq2, pulses2, q_ids = E.decode_payload(got, stats, jcfg.state_dim,
                                               jcfg.pvq_num_pulses)
        assert np.array_equal(zq2, zq) and np.array_equal(pulses2, pulses)
        assert np.array_equal(q_ids, JE.payload_q_ids(n_lat, q0, q1))
    with pytest.raises(ValueError):
        E.decode_payload(bytes([0x20]) + got[1:], stats, jcfg.state_dim,
                         jcfg.pvq_num_pulses)


def test_payload_roundtrip_model():
    """The whole pipeline on the port's RDO-VAE: the payload bytes decode to
    the symbols, and their features equal the non-entropy path's."""
    from lpcnet_torch.dred.coder import DREDDecoder, DREDEncoder
    cfg = RV.RDOVAEConfig(**SMALL)
    params = RV.init_params(cfg, 0)
    enc = DREDEncoder(params, cfg, batch=2, device="cpu")
    rng = np.random.RandomState(5)
    for _ in range(12):
        enc.add_feature_frame(rng.randn(2, cfg.num_features).astype(np.float32))
    out = enc.produce_payload(num_redundancy_frames=8, q0=3, q1=9)
    assert out is not None and len(out["payloads"]) == 2
    dec = DREDDecoder(params, cfg, device="cpu")
    ref = dec.decode_all(out["zq"], out["q_ids"], out["state"])
    for b, payload in enumerate(out["payloads"]):
        assert isinstance(payload, bytes) and len(payload) > 3
        np.testing.assert_allclose(dec.decode_payload(payload)[0], ref[b], atol=1e-5)
        assert len(payload) < 4 * out["bits"][b] / 8 + 64


def test_stats_fixed_point_layout():
    cfg = RV.RDOVAEConfig()
    st = E.stats_fixed_point(RV.init_params(cfg, 0), cfg)
    for k in ["quant_scales_q8", "dead_zone_q10", "r_q15", "p0_q15"]:
        assert st[k].shape == (cfg.quant_levels, cfg.latent_dim)
        assert st[k].dtype == np.uint16
    assert np.all(st["r_q15"] >= 1) and np.all(st["r_q15"] < 32768)
    assert np.all(st["p0_q15"] >= 1) and np.all(st["p0_q15"] < 32768)


@pytest.mark.parametrize("which", ["demo", "seeded"])
def test_stats_fixed_point_equal_jax(which):
    """The Q8/Q10/Q15 tables equal the JAX package's: on the demo model's
    statistical table and on a seeded one spread over softplus's and the
    sigmoid's working range."""
    cfg, jcfg = RV.RDOVAEConfig(), JR.RDOVAEConfig()
    if which == "demo":
        params, _ = api.load_rdovae_model(api.DEMO_RDOVAE_MODEL_PATH, device="cpu")
        table = params["statistical_model"]["quant_embedding"]["table"].numpy()
    else:
        table = (2.0 * np.random.RandomState(8).randn(
            cfg.quant_levels, 6 * cfg.latent_dim)).astype(np.float32)
    params = {"statistical_model": {"quant_embedding": {"table": table}}}
    got = E.stats_fixed_point(params_to_torch(params), cfg)
    want = JE.stats_fixed_point(params, jcfg)
    for k in want:
        assert np.array_equal(got[k], want[k]), (k, int(np.sum(got[k] != want[k])))
