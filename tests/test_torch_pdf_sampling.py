"""The full-PDF excitation sampler (the reference's Python synthesis:
voicing temperature, tail cut, one KISS99 draw) in the port against the JAX
package on the CPU: the sampler, `synthesize_frame(pdf_corr=...)` and `cli
synthesis --sampling pdf`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu import cli as jcli
from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.nn import layers as JNN
from lpcnet_tpu.train.losses import tree_to_pdf as j_tree_to_pdf

from lpcnet_torch import api, cli
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.utils.rng import Kiss99State
from lpcnet_torch.weights.convert import params_to_torch, sample_state_to_numpy

torch.set_num_threads(1)

SMALL = dict(rnn_units1=64, rnn_units2=16, cond_size=32, pitch_embed_dim=8)
JCFG, TCFG = JM.LPCNetConfig(**SMALL), M.LPCNetConfig(**SMALL)


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def fused():
    p = _numpy_tree(M.init_params(TCFG, seed=8))
    return (JM.fuse_inference_params(jax.tree.map(jnp.asarray, p), JCFG),
            M.fuse_inference_params(params_to_torch(p), TCFG))


def _rng_words(b, seed):
    """Seeded KISS99 words [4, B] within the 32-bit range."""
    return np.random.RandomState(seed).randint(1, 2 ** 32 - 1, (4, b), dtype=np.int64)


def _jax_rng(words):
    from lpcnet_tpu.utils.rng import Kiss99State as JKiss
    return JKiss(*(jnp.asarray(w.astype(np.uint32)) for w in words))


def _jax_pdf(dual_fc, h_b, corr):
    """The JAX sampler's distribution, line for line
    (lpcnet_tpu/models/lpcnet.py::sample_excitation_pdf)."""
    pdf = j_tree_to_pdf(JNN.mdense(dual_fc, h_b))
    power = jnp.maximum(0.0, 1.5 * corr - 0.5)[..., None]
    pdf = pdf * jnp.power(jnp.clip(pdf, 1e-18, 1.0), power)
    pdf = pdf / (1e-18 + jnp.sum(pdf, axis=-1, keepdims=True))
    pdf = jnp.maximum(pdf - 0.002, 0.0)
    return pdf / (1e-8 + jnp.sum(pdf, axis=-1, keepdims=True))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_excitation_pdf_matches_jax(fused, seed):
    """On the same h_b, corr and KISS99 words: the pdf within 1e-6, the
    excitation equal on every draw and the new words equal; corr spans the
    temperature's off range (<= 1/3) and its on range."""
    jf, tf = fused
    b = 256
    rs = np.random.RandomState(100 + seed)
    h_b = np.tanh(rs.normal(size=(b, TCFG.rnn_units2)) * 1.5).astype(np.float32)
    corr = rs.uniform(-0.5, 1.0, b).astype(np.float32)
    words = _rng_words(b, seed)
    pdf = M.excitation_pdf(tf["dual_fc"], torch.from_numpy(h_b), torch.from_numpy(corr))
    np.testing.assert_allclose(pdf.numpy(), np.asarray(_jax_pdf(jf["dual_fc"], h_b, corr)),
                               atol=1e-6, rtol=0)
    exc, rng = M.sample_excitation_pdf(tf["dual_fc"], torch.from_numpy(h_b),
                                       Kiss99State(*torch.from_numpy(words)),
                                       torch.from_numpy(corr))
    jexc, jrng = JM.sample_excitation_pdf(jf["dual_fc"], jnp.asarray(h_b),
                                          _jax_rng(words), jnp.asarray(corr))
    assert exc.dtype == torch.int32
    assert np.array_equal(exc.numpy(), np.asarray(jexc))
    for t, j in zip(rng, jrng):
        assert np.array_equal(t.numpy(), np.asarray(j).astype(np.int64))


def test_pdf_sampling_properties(fused):
    """test_lpcnet_model.py:120's properties on the port: deterministic,
    different from the bit tree, finite; and the temperature at work: the
    pdf's entropy at corr 0.9 below that at corr -0.2, on every one of 64
    states."""
    _, tf = fused
    b = 2
    rs = np.random.RandomState(0)
    state = M.init_sample_state(b, TCFG)
    ca = torch.from_numpy(rs.randn(b, 3 * TCFG.rnn_units1).astype(np.float32))
    cb = torch.from_numpy(rs.randn(b, 3 * TCFG.rnn_units2).astype(np.float32))
    lpc = torch.from_numpy((rs.randn(b, 16) * 0.05).astype(np.float32))
    corr = torch.tensor([0.9, -0.2])
    _, p1 = M.synthesize_frame(tf, state, ca, cb, lpc, n_samples=32, pdf_corr=corr)
    _, p2 = M.synthesize_frame(tf, state, ca, cb, lpc, n_samples=32, pdf_corr=corr)
    _, p3 = M.synthesize_frame(tf, state, ca, cb, lpc, n_samples=32)
    assert torch.equal(p1, p2) and not torch.equal(p1, p3)
    assert torch.isfinite(p1).all()
    h_b = torch.tanh(torch.from_numpy(rs.randn(64, TCFG.rnn_units2).astype(np.float32)))
    ent = []
    for c in (0.9, -0.2):
        pdf = M.excitation_pdf(tf["dual_fc"], h_b, torch.full((64,), c))
        ent.append(-(pdf * torch.log(torch.clamp(pdf, min=1e-30))).sum(-1))
        assert torch.allclose(pdf.sum(-1), torch.ones(64), atol=1e-5)
    assert bool((ent[0] < ent[1]).all())
    exc, _ = M.sample_excitation_pdf(tf["dual_fc"], h_b[:b], state.rng, corr)
    assert exc.shape == (b,) and int(exc.min()) >= 0 and int(exc.max()) < 256


def test_synthesize_frame_pdf_matches_jax(fused):
    """synthesize_frame(pdf_corr=...) over 32 steps against the JAX
    package's from the same conditioning and state: >=98 % exact PCM and the
    KISS99 words in lockstep (K1's f32 bar)."""
    jf, tf = fused
    b = 16
    rs = np.random.RandomState(5)
    fs = M.init_frame_state(b, TCFG)
    for _ in range(3):
        f = torch.from_numpy((rs.normal(size=(b, 36)) * 0.3).astype(np.float32))
        fs, _, ca, cb, lpc = M.frame_network(tf, fs, f, TCFG)
    corr = torch.from_numpy(rs.uniform(0.0, 1.0, b).astype(np.float32))
    s0 = M.init_sample_state(b, TCFG)
    ts, tp = M.synthesize_frame(tf, s0, ca, cb, lpc, n_samples=32, pdf_corr=corr)
    js, jp = jax.jit(JM.synthesize_frame, static_argnames=("n_samples",))(
        jf, JM.init_sample_state(b, JCFG), ca.numpy(), cb.numpy(), lpc.numpy(),
        n_samples=32, pdf_corr=corr.numpy())
    assert np.mean(tp.numpy() == np.asarray(jp)) >= 0.98
    t = sample_state_to_numpy(ts)
    for f, x in zip(("z", "w", "jsr", "jcong"), js.rng):
        assert np.array_equal(t[f], np.asarray(x)), f
    assert np.abs(tp.numpy()).max() > 0


def test_cli_synthesis_pdf_matches_jax_cli(tmp_path):
    """`cli synthesis --sampling pdf --device cpu` on 4 frames of seeded
    features with the demo vocoder against the JAX cli: int16, zeros while
    the lookahead fills, then >=98 % of the samples exact and not silent."""
    rs = np.random.RandomState(21)
    f = (rs.normal(size=(4, 36)) * 0.3).astype(np.float32)
    f[:, 18] = rs.uniform(-0.5, 0.5, 4)
    f[:, 19] = rs.uniform(0.0, 0.9, 4)
    fin, tout, jout = (tmp_path / k for k in ("f.f32", "t.pcm", "j.pcm"))
    f.tofile(fin)
    cli.main(["synthesis", str(fin), str(tout), "--sampling", "pdf", "--device", "cpu",
              "--model", api.DEMO_MODEL_PATH])
    jcli.main(["synthesis", str(fin), str(jout), "--sampling", "pdf",
               "--model", api.DEMO_MODEL_PATH])
    got, want = (np.fromfile(p, np.int16) for p in (tout, jout))
    assert got.shape == want.shape == (4 * 160,)
    la = M.LPCNetConfig().lookahead
    assert not got[:la * 160].any()
    assert got[la * 160:].any()
    assert np.mean(got == want) >= 0.98
