"""DRED's RDO-VAE in the port (`lpcnet_torch.models.rdovae`) against the JAX
package's, on the CPU, from the same JAX weights carried across: the cases
of test_rdovae.py, each also held to the JAX function on the same inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import rdovae as JR

from lpcnet_torch.models import rdovae as RV
from lpcnet_torch.nn import layers as nn
from lpcnet_torch.weights.convert import (grads_to_numpy, params_to_torch,
                                          train_params_to_torch)

torch.set_num_threads(1)

TINY = dict(latent_dim=8, cond_size=16, cond_size2=12, state_dim=6,
            pvq_num_pulses=12, state_hidden=10)


def _cfgs(**kw):
    return JR.RDOVAEConfig(**kw), RV.RDOVAEConfig(**kw)


@pytest.fixture(scope="module")
def tiny():
    """JAX params (PRNGKey(0), a non-zero statistical table) and the same
    weights as the port's tensors."""
    jcfg, cfg = _cfgs(**TINY)
    jp = JR.init_params(jax.random.PRNGKey(0), jcfg)
    jp["statistical_model"]["quant_embedding"]["table"] = 0.3 * jax.random.normal(
        jax.random.PRNGKey(9), (jcfg.quant_levels, 6 * jcfg.latent_dim))
    npp = jax.tree.map(np.asarray, jp)
    return jcfg, cfg, jp, npp, params_to_torch(npp)


def _flat(tree, prefix=""):
    """A nested dict -> {'a/b': leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _feats(seed, shape):
    return (np.random.RandomState(seed).randn(*shape) * 0.3).astype(np.float32)


def test_config_matches_jax():
    jcfg, cfg = JR.RDOVAEConfig(), RV.RDOVAEConfig()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    for prop in ("enc_input_dim", "enc_concat_size", "dec_concat_size"):
        assert getattr(jcfg, prop) == getattr(cfg, prop)
    jc, c = _cfgs(cond_size=32, cond_size2=24)
    assert jc.dec_concat_size == c.dec_concat_size == 3 * 32 + 5 * 24


def test_init_params_layout_and_seed():
    """The port's numpy-seeded init has JAX's tree, shapes and families."""
    jcfg, cfg = _cfgs(**TINY)
    jp = _flat(jax.eval_shape(lambda k: JR.init_params(k, jcfg),
                              jax.random.PRNGKey(0)))
    a, b, c = (RV.init_params(cfg, s) for s in (1, 1, 2))
    flat = _flat
    assert ({k: tuple(v.shape) for k, v in flat(a).items()}
            == {k: tuple(v.shape) for k, v in jp.items()})
    for k, v in flat(a).items():
        assert v.dtype == torch.float32
        assert torch.equal(v, flat(b)[k])
        if k.endswith("bias") or k.startswith("statistical"):
            assert not v.any(), k
        else:
            assert not torch.equal(v, flat(c)[k]), k
    rec = a["encoder"]["gru_1"]["recurrent"]
    n = rec.shape[0]
    for g in range(3):                       # one orthogonal block a gate
        blk = rec[:, g * n:(g + 1) * n].double()
        assert torch.allclose(blk.T @ blk, torch.eye(n, dtype=torch.float64),
                              atol=1e-6)


def test_conv1d_seq_causal():
    """'causal' is 'valid' over k-1 zero frames, and the streaming conv from
    a zero ring gives the same outputs."""
    rs = np.random.RandomState(3)
    p = {"kernel": torch.from_numpy(rs.randn(4, 5, 3).astype(np.float32)),
         "bias": torch.from_numpy(rs.randn(3).astype(np.float32))}
    x = torch.from_numpy(rs.randn(2, 7, 5).astype(np.float32))
    y = nn.conv1d_seq(p, x, "linear", padding="causal")
    assert y.shape == (2, 7, 3)
    ref = nn.conv1d_seq(p, torch.cat([torch.zeros(2, 3, 5), x], 1), "linear")
    assert torch.equal(y, ref)
    mem = torch.zeros(2, 3, 5)
    for t in range(7):
        out, mem = nn.conv1d_stream(p, x[:, t], mem, "linear")
        torch.testing.assert_close(out, y[:, t], atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        nn.conv1d_seq(p, x, padding="same")


def test_encode_decode_shapes(tiny):
    _, cfg, _, _, tp = tiny
    feats = torch.from_numpy(_feats(1, (2, 16, 20)))
    z, states = RV.encode_seq(tp, feats, cfg)
    assert z.shape == (2, 8, cfg.latent_dim)
    assert states.shape == (2, 8, cfg.state_dim)
    assert RV.decode_seq(tp, z[:, ::2], states[:, -1], cfg).shape == (2, 16, 20)


def test_sequence_forms_match_jax(tiny):
    """encode_seq and decode_seq within 1e-5 of JAX's on the same weights."""
    jcfg, cfg, jp, _, tp = tiny
    feats = _feats(2, (3, 12, 20))
    jz, jst = JR.encode_seq(jp, jnp.asarray(feats), jcfg)
    z, st = RV.encode_seq(tp, torch.from_numpy(feats), cfg)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-5, rtol=0)
    jdec = JR.decode_seq(jp, jz[:, ::2], jst[:, -1], jcfg)
    dec = RV.decode_seq(tp, torch.from_numpy(np.array(jz[:, ::2])),
                        torch.from_numpy(np.array(jst[:, -1])), cfg)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=1e-5, rtol=0)


def test_streaming_matches_sequence_and_jax(tiny):
    """encode_dframe over 6 dframes equals encode_seq; decode_qframe equals
    decode_seq; and both streaming steps equal JAX's step by step."""
    jcfg, cfg, jp, _, tp = tiny
    feats = _feats(2, (3, 12, 20))
    z_seq, st_seq = RV.encode_seq(tp, torch.from_numpy(feats), cfg)
    es, js = RV.init_encoder_stream(3, cfg), JR.init_encoder_stream(3, jcfg)
    zs, sts = [], []
    for t in range(6):
        pair = feats[:, 2 * t:2 * t + 2].reshape(3, -1)
        es, z, st = RV.encode_dframe(tp, es, torch.from_numpy(pair), cfg)
        js, jz, jst = JR.encode_dframe(jp, js, jnp.asarray(pair), jcfg)
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-5, rtol=0)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-5, rtol=0)
        for a, b in zip(es, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
        zs.append(z)
        sts.append(st)
    torch.testing.assert_close(torch.stack(zs, 1), z_seq, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(torch.stack(sts, 1), st_seq, rtol=1e-4, atol=1e-5)

    z_dec, init = z_seq[:, ::2], st_seq[:, -1]
    ref = RV.decode_seq(tp, z_dec, init, cfg)
    ds = RV.init_decoder_stream(tp, init, cfg)
    jds = JR.init_decoder_stream(jp, jnp.asarray(init.numpy()), jcfg)
    outs = []
    for t in range(z_dec.shape[1]):
        ds, frames = RV.decode_qframe(tp, ds, z_dec[:, t], cfg)
        jds, jframes = JR.decode_qframe(jp, jds, jnp.asarray(z_dec[:, t].numpy()),
                                        jcfg)
        np.testing.assert_allclose(frames.numpy(), np.asarray(jframes),
                                   atol=1e-5, rtol=0)
        outs.append(frames)
    torch.testing.assert_close(torch.cat(outs, 1), ref, rtol=1e-4, atol=1e-5)


def test_soft_pvq_properties_and_jax():
    """Unit norm; the quantized point is a k-pulse vector's direction; equal
    to JAX's soft_pvq; the gradient is x's unit vector's."""
    k = 12
    x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    q = RV.soft_pvq(xt, k)
    np.testing.assert_allclose(torch.linalg.vector_norm(q, dim=-1).detach().numpy(),
                               1.0, rtol=1e-4)
    np.testing.assert_allclose(q.detach().numpy(),
                               np.asarray(JR.soft_pvq(jnp.asarray(x), k)),
                               atol=1e-6, rtol=0)
    pulses = q.detach().numpy() / np.abs(q.detach().numpy()).sum(-1, keepdims=True) * k
    np.testing.assert_allclose(pulses, np.round(pulses), atol=1e-4)
    w = torch.from_numpy(np.random.RandomState(4).randn(4, 6).astype(np.float32))
    (q * w).sum().backward()
    xr = torch.from_numpy(x).requires_grad_(True)
    (RV._unit(xr) * w).sum().backward()
    torch.testing.assert_close(xt.grad, xr.grad)
    # round half to even, as jnp.round
    assert torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5])).tolist() == [0, 2, 2, 0]


def test_pvq_codebook_size_and_bits():
    for n, k in ((4, 3), (6, 12), (24, 82)):
        assert RV.pvq_codebook_size(n, k) == JR.pvq_codebook_size(n, k)
    assert RV.pvq_codebook_size(2, 1) == 4
    assert RV.pvq_state_bits(RV.RDOVAEConfig()) == JR.pvq_state_bits(JR.RDOVAEConfig())


def test_rate_estimates_positive_and_jax():
    rs = np.random.RandomState(4)
    z = (rs.randn(2, 6, 8) * 2).astype(np.float32)
    r = rs.uniform(0.2, 0.9, (2, 6, 8)).astype(np.float32)
    theta = rs.uniform(0.1, 0.9, (2, 6, 8)).astype(np.float32)
    zt, rt, tt = (torch.from_numpy(a) for a in (z, r, theta))
    assert float(RV.soft_rate_estimate(zt, rt)) > 0
    assert float(RV.hard_rate_estimate(zt, rt, tt)) > 0
    for reduce in (True, False):
        np.testing.assert_allclose(
            RV.soft_rate_estimate(zt, rt, reduce).numpy(),
            np.asarray(JR.soft_rate_estimate(z, r, reduce)), rtol=1e-5)
        np.testing.assert_allclose(
            RV.hard_rate_estimate(zt, rt, tt, reduce).numpy(),
            np.asarray(JR.hard_rate_estimate(z, r, theta, reduce)), rtol=1e-5)
    dz = rs.uniform(0, 3, (2, 6, 8)).astype(np.float32)
    np.testing.assert_allclose(
        RV.soft_dead_zone(zt, torch.from_numpy(dz)).numpy(),
        np.asarray(JR.soft_dead_zone(z, dz)), atol=1e-6)


def test_statistical_model_matches_jax(tiny):
    jcfg, cfg, jp, _, tp = tiny
    q = np.random.RandomState(5).randint(0, cfg.quant_levels, (2, 7))
    js = JR.statistical_model(jp, jnp.asarray(q), jcfg)
    ts = RV.statistical_model(tp, torch.from_numpy(q), cfg)
    assert set(js) == set(ts)
    for k in ts:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_distortion_loss_matches_jax():
    rs = np.random.RandomState(6)
    yt, yp = (rs.randn(2, 8, 20).astype(np.float32) for _ in range(2))
    lam = rs.uniform(1e-3, 1e-1, (2, 8)).astype(np.float32)
    for lm in (None, lam):
        got = RV.distortion_loss(torch.from_numpy(yt), torch.from_numpy(yp),
                                 None if lm is None else torch.from_numpy(lm))
        want = JR.distortion_loss(yt, yp, lm)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("z_frames", [4, 7, 8, 16, 33])
def test_get_decoder_chunks_equal(z_frames):
    jcfg, cfg = _cfgs()
    assert RV.get_decoder_chunks(z_frames, cfg) == JR.get_decoder_chunks(z_frames, jcfg)
    assert (RV.get_decoder_chunks(z_frames, cfg, 2)
            == JR.get_decoder_chunks(z_frames, jcfg, 2))


def test_rdovae_loss_and_grad_match_jax(tiny):
    """The training loss, its parts and every gradient leaf against JAX's
    on the same weights, inputs and soft-quant noise (JAX's draw fed in):
    outputs within 1e-5, gradients within 1e-4 of each leaf's largest
    entry."""
    jcfg, cfg, jp, npp, _ = tiny
    rs = np.random.RandomState(5)
    feats = (rs.randn(2, 32, 20) * 0.3).astype(np.float32)
    lam = np.full((2, 16), 0.001, np.float32)
    q_ids = np.full((2, 16), 3, np.int32)
    key = jax.random.PRNGKey(6)
    loss_fn = lambda p: JR.rdovae_loss(p, jnp.asarray(feats), jnp.asarray(lam),
                                       jnp.asarray(q_ids), key, jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    noise = np.asarray(jax.random.uniform(jax.random.split(key)[0],
                                          (2, 16, cfg.latent_dim)))
    tp = train_params_to_torch(npp)
    tl, tm = RV.rdovae_loss(tp, torch.from_numpy(feats), torch.from_numpy(lam),
                            torch.from_numpy(q_ids), None, cfg,
                            noise=torch.from_numpy(noise))
    assert np.isfinite(float(tl.detach()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-5, rtol=0)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), atol=1e-5,
                                   rtol=1e-6, err_msg=k)
    tl.backward()
    got = grads_to_numpy(tp)
    want = {k: np.asarray(v) for k, v in _flat(jg).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        scale = max(float(np.abs(v).max()), 1e-12)
        assert float(np.abs(got[k] - v).max()) <= 1e-4 * scale, k
    assert sum(float((g ** 2).sum()) for g in got.values()) > 0


def test_state_dropout_and_noise_draws():
    """The generator makes the draws repeatable; state dropout at rate 1
    (where JAX's draw drops every sequence too) zeroes every decoder init,
    so the decoded outputs no longer depend on the encoder's states."""
    jcfg, cfg = _cfgs(**TINY)
    tp = RV.init_params(cfg, 3)
    feats = torch.from_numpy(_feats(7, (2, 32, 20)))
    q_ids = torch.full((2, 16), 2)
    outs = [RV.training_forward(tp, feats, q_ids, torch.Generator().manual_seed(1),
                                cfg, state_dropout_rate=r) for r in (0.0, 1.0, 1.0)]
    a, b = outs[1], outs[2]
    for (d1, *_), (d2, *_) in zip(a["outputs_soft_quant"], b["outputs_soft_quant"]):
        assert torch.equal(d1, d2)
    # with every init state zero, the hard-quant outputs no longer depend on
    # the encoder's states: changing state_dense_2's bias changes nothing
    tp2 = {**tp, "encoder": {**tp["encoder"], "state_dense_2": {
        "kernel": tp["encoder"]["state_dense_2"]["kernel"],
        "bias": torch.full((cfg.state_dim,), 0.7)}}}
    c = RV.training_forward(tp2, feats, q_ids, torch.Generator().manual_seed(1),
                            cfg, state_dropout_rate=1.0)
    for (d1, *_), (d2, *_) in zip(a["outputs_hard_quant"], c["outputs_hard_quant"]):
        assert torch.equal(d1, d2)
    d = outs[0]
    assert any(not torch.equal(d1, d2) for (d1, *_), (d2, *_) in
               zip(d["outputs_hard_quant"], a["outputs_hard_quant"]))


def test_dred_coder_roundtrip():
    """The cases of test_rdovae.py::test_dred_coder_roundtrip on the port."""
    from lpcnet_torch.dred.coder import DREDDecoder, DREDEncoder
    _, cfg = _cfgs(**TINY)
    params = RV.init_params(cfg, 0)
    params["statistical_model"]["quant_embedding"]["table"] = torch.from_numpy(
        (0.1 * np.random.RandomState(9).randn(cfg.quant_levels, 6 * cfg.latent_dim)
         ).astype(np.float32))
    enc = DREDEncoder(params, cfg, batch=2, device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(16):
        enc.add_feature_frame(rng.randn(2, 20).astype(np.float32) * 0.3)
    payload = enc.produce_payload(num_redundancy_frames=8, q0=3, q1=9)
    assert payload is not None
    assert payload["zq"].shape == (2, 4, cfg.latent_dim)
    assert np.all(payload["bits"] > 0)
    assert enc.produce_payload(num_redundancy_frames=20) is None
    dec = DREDDecoder(params, cfg, device="cpu")
    feats = dec.decode_all(payload["zq"], payload["q_ids"], payload["state"])
    assert feats.shape == (2, 16, 20)
    assert np.isfinite(feats).all()
