"""lpcnet_torch DSP and numerics vs the JAX package, on the CPU: KISS99,
u-law, LPC, and the C table activations. Inputs come from numpy seeds."""

import os

import jax
import numpy as np
import pytest
import torch

from lpcnet_tpu.dsp import constants as jconst
from lpcnet_tpu.dsp import lpc as jlpc
from lpcnet_tpu.dsp import mulaw as jmulaw
from lpcnet_tpu.nn import layers as jlayers
from lpcnet_tpu.utils import rng as jrng

from lpcnet_torch.dsp import constants as tconst
from lpcnet_torch.dsp import lpc as tlpc
from lpcnet_torch.dsp import mulaw as tmulaw
from lpcnet_torch.nn import layers as tlayers
from lpcnet_torch.utils import rng as trng

# the plain path is many small ops: one intra-op thread per process keeps
# parallel pytest workers from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def recomputed_tansig_tables(monkeypatch):
    """Both packages on their recomputed C tansig table: a C-gate module
    run earlier in the same process may have installed the reference's
    own table in either package. monkeypatch restores it afterwards."""
    monkeypatch.setattr(jlayers, "_TANSIG_TABLE", None)
    monkeypatch.setattr(tlayers, "_TANSIG_TABLE", None)


@pytest.mark.parametrize("name", [
    "LPC_ORDER", "PREEMPHASIS", "FRAME_SIZE", "WINDOW_SIZE", "FREQ_SIZE",
    "NB_BANDS", "NB_FEATURES", "NB_TOTAL_FEATURES", "EBAND5MS",
    "COMPENSATION", "HALF_WINDOW", "FULL_WINDOW", "DCT_MATRIX",
    "BAND_INTERP", "BAND_ENERGY_MATRIX"])
def test_constants_match_jax(name):
    """The port's own copy of the DSP constants equals the JAX package's,
    value and dtype."""
    want, got = getattr(jconst, name), getattr(tconst, name)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    assert np.array_equal(got, want)


def test_kiss99_single_stream_seed():
    js = jrng.kiss99_srand()
    ts = trng.kiss99_srand()
    for _ in range(8):
        jv, js = jrng.kiss99_step(js)
        tv, ts = trng.kiss99_step(ts)
        assert int(jv) == int(tv)
    assert [int(x) for x in js] == [int(x) for x in ts]


def test_kiss99_streams_bit_exact():
    """C seed + per-stream perturbation, then 100 draws x 1000 streams."""
    js = jrng.kiss99_srand(n_streams=1000)
    ts = trng.kiss99_srand(n_streams=1000)
    for a, b in zip(js, ts):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy())
    for _ in range(100):
        jv, js = jrng.kiss99_step(js)
        tv, ts = trng.kiss99_step(ts)
        assert np.array_equal(np.asarray(jv).astype(np.int64), tv.numpy())
    for a, b in zip(js, ts):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy())


def _ulaw_grid(ulaw_fixture):
    rs = np.random.RandomState(0)
    edges = np.asarray(jmulaw.ulaw2lin(np.arange(256) + 0.5))  # code ties
    return np.concatenate([
        [0.0, -0.0, 32767.0, -32767.0, 32768.0, -32768.0, 1e6, -1e6],
        np.linspace(-32768, 32768, 20001), edges,
        np.nextafter(edges.astype(np.float32), np.float32(np.inf)),
        np.nextafter(edges.astype(np.float32), np.float32(-np.inf)),
        rs.normal(0, 3000, 5000), ulaw_fixture["lin_in"],
    ]).astype(np.float32)


def test_lin2ulaw_exact(ulaw_fixture):
    x = _ulaw_grid(ulaw_fixture)
    want = np.asarray(jmulaw.lin2ulaw(x))
    got = tmulaw.lin2ulaw(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def test_ulaw2lin_exact_and_roundtrip():
    """Exact against the formula with a correctly rounded exp. The JAX
    package's CPU exp (XLA) is 1 ulp off on 22 of 256 codes; against JAX
    the port agrees to 1e-6 relative (a gap recorded in ROADMAP.md)."""
    codes = np.arange(256)
    got = tmulaw.ulaw2lin(torch.from_numpy(codes)).numpy()
    u = codes.astype(np.float32) - np.float32(128.0)
    arg = np.abs(u) / np.float32(128.0) * np.float32(tmulaw.LOG256)
    e = np.exp(arg.astype(np.float64)).astype(np.float32)
    s = np.where(u >= 0, np.float32(1.0), np.float32(-1.0))
    want = s * np.float32(tmulaw._SCALE_1) * (e - np.float32(1.0))
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got, np.asarray(jmulaw.ulaw2lin(codes)), rtol=1e-6)
    back = tmulaw.lin2ulaw(torch.from_numpy(got)).numpy()
    assert np.array_equal(back, codes)


def _ceps():
    """Cepstra of real speech (the C-extracted fixture features) plus a flat
    spectrum, near silence and a loud frame."""
    f = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             "demo_features.npy"))[:, :18]
    edge = np.zeros((3, 18), np.float32)
    edge[1, 0] = -30.0
    edge[2, 0] = 8.0
    return np.concatenate([edge, f]).astype(np.float32)


def test_lpc_from_cepstrum_matches_jax():
    c = _ceps()
    want = np.asarray(jax.jit(jlpc.lpc_from_cepstrum)(c))
    got = tlpc.lpc_from_cepstrum(torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_levinson_matches_jax_including_silence():
    rs = np.random.RandomState(2)
    sig = rs.normal(size=(32, 400))
    ac = np.stack([np.array([np.dot(s[:400 - k], s[k:]) for k in range(17)])
                   for s in sig]).astype(np.float32)
    ac[0] = 0.0                                   # silence: lpc stays 0
    ac[1] = 0.0
    ac[1, 0] = 1.0                                # white: early exit
    jl, jr, je = (np.asarray(x) for x in jax.jit(jlpc.levinson)(ac))
    tl, tr, te = (x.numpy() for x in tlpc.levinson(torch.from_numpy(ac)))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tr, jr, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(te, je, rtol=1e-4, atol=1e-4)
    assert not tl[0].any()


def test_rc2lpc_and_weighting_match_jax():
    rc = np.random.RandomState(3).uniform(-0.95, 0.95, (16, 16)).astype(np.float32)
    np.testing.assert_allclose(tlpc.rc2lpc(torch.from_numpy(rc)).numpy(),
                               np.asarray(jax.jit(jlpc.rc2lpc)(rc)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tlpc.lpc_weighting(torch.from_numpy(rc), 0.92).numpy(),
        np.asarray(jlpc.lpc_weighting(rc, 0.92)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fn", ["tanh_cref", "sigmoid_cref"])
def test_cref_activations_exact(fn):
    x = np.concatenate([np.linspace(-10, 10, 40001),
                        0.04 * np.arange(-250, 251) + 0.02]).astype(np.float32)
    want = np.asarray(getattr(jlayers, fn)(x))
    got = getattr(tlayers, fn)(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


def test_activation_switch_restores():
    x = torch.linspace(-3, 3, 101)
    with tlayers.activation_impl("cref"):
        assert torch.equal(tlayers.tanh(x), tlayers.tanh_cref(x))
    assert torch.equal(tlayers.tanh(x), torch.tanh(x))


def _layer_params(rs):
    n, cin = 8, 12
    f = lambda *sh: rs.normal(0, 0.5, sh).astype(np.float32)
    return {"dense": {"kernel": f(cin, n), "bias": f(n)},
            "conv": {"kernel": f(3, cin, n), "bias": f(n)},
            "gru": {"recurrent": f(n, 3 * n), "bias": f(2, 3 * n)},
            "mdense": {"kernel": f(n, 256, 2), "bias": f(256, 2),
                       "factor": f(256, 2)},
            "table": {"table": f(256, n)}}


@pytest.mark.parametrize("impl", ["exact", "cref"])
def test_layers_match_jax(impl):
    rs = np.random.RandomState(4)
    p = _layer_params(rs)
    tp = {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in p.items()}
    x = rs.normal(size=(5, 12)).astype(np.float32)
    mem = rs.normal(size=(5, 2, 12)).astype(np.float32)
    h = rs.normal(size=(5, 8)).astype(np.float32)
    g = rs.normal(size=(5, 24)).astype(np.float32)
    idx = rs.randint(0, 256, 5)
    rows = rs.randint(0, 256, 5)
    tx, th = torch.from_numpy(x), torch.from_numpy(h)
    with jlayers.activation_impl(impl), tlayers.activation_impl(impl):
        pairs = [
            (jlayers.dense(p["dense"], x, "tanh"),
             tlayers.dense(tp["dense"], tx, "tanh")),
            (jlayers.conv1d_stream(p["conv"], x, mem)[0],
             tlayers.conv1d_stream(tp["conv"], tx, torch.from_numpy(mem))[0]),
            (jlayers.gru_precomputed_step(p["gru"], h, g),
             tlayers.gru_precomputed_step(tp["gru"], th, torch.from_numpy(g))),
            (jlayers.embedding(p["table"], idx),
             tlayers.embedding(tp["table"], torch.from_numpy(idx))),
            (jlayers.mdense_logits_pair(p["mdense"], h, rows),
             tlayers.mdense_logits(tp["mdense"], th)[torch.arange(5),
                                                      torch.from_numpy(rows)]),
        ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
