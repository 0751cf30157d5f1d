"""The sample-loop kernel's Python side (bundle, plain version, wrapper) vs
the JAX package, on the CPU. The CUDA kernel itself is held against its
plain version in test_torch_cuda.py."""

import os

os.environ["LPCNET_PALLAS_INTERPRET"] = "1"  # before the JAX kernels import

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.kernels import sample_loop as JK
from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.nn import quantized as JQ

from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.nn import quantized as Q
from lpcnet_torch.weights.convert import params_to_torch, sample_state_to_numpy

# the plain path is many small ops: one intra-op thread per process keeps
# parallel pytest workers from oversubscribing the cores
torch.set_num_threads(1)

SMALL = dict(rnn_units1=64, rnn_units2=16, cond_size=32, pitch_embed_dim=8)
JCFG, TCFG = JM.LPCNetConfig(**SMALL), M.LPCNetConfig(**SMALL)


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def fused():
    """(JAX fused, port fused) from one numpy-seeded init."""
    p = _numpy_tree(M.init_params(TCFG, seed=4))
    return (JM.fuse_inference_params(jax.tree.map(jnp.asarray, p), JCFG),
            M.fuse_inference_params(params_to_torch(p), TCFG))


def _inputs(tf, b, seed=11, frames=3):
    """Frame-net conditioning after `frames` frames + a fresh sample state.
    After 3 frames the LPC is live; after 1 (the recipe of the JAX
    package's kernel-vs-scan tests) it is still zero."""
    rs = np.random.RandomState(seed)
    fs = M.init_frame_state(b, TCFG)
    for _ in range(frames):
        f = torch.from_numpy((rs.normal(size=(b, 36)) * 0.3).astype(np.float32))
        fs, _, ca, cb, lpc = M.frame_network(tf, fs, f, TCFG)
    return (ca.contiguous(), cb.contiguous(), lpc.contiguous(),
            M.init_sample_state(b, TCFG))


def _jax_state(ts):
    s = sample_state_to_numpy(ts)
    from lpcnet_tpu.utils.rng import Kiss99State
    return JM.SampleState(
        jnp.asarray(s["gru_a"]), jnp.asarray(s["gru_b"]),
        jnp.asarray(s["last_sig"]), jnp.asarray(s["last_exc"]),
        jnp.asarray(s["deemph"]),
        Kiss99State(*(jnp.asarray(s[k]) for k in ("z", "w", "jsr", "jcong"))))


def _as_f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


@pytest.mark.parametrize("form", ["f32", "bf16", "q8_from_float", "q8"])
def test_kernel_weights_match_jax(fused, form):
    jf, tf = fused
    if form == "q8":
        jkw = JK.kernel_weights(JQ.quantize_fused(jf), JCFG)
        tkw = K.kernel_weights(Q.quantize_fused(tf), TCFG)
    elif form == "q8_from_float":
        jkw = JK.kernel_weights(jf, JCFG, quantized=True)
        tkw = K.kernel_weights(tf, TCFG, quantized=True)
    else:
        dt = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[form]
        jkw = JK.kernel_weights(jf, JCFG, dtype=dt[0])
        tkw = K.kernel_weights(tf, TCFG, dtype=dt[1])
    # the JAX float bundle also carries the merged-matmul layout (K6)
    assert set(tkw) <= set(jkw)
    assert K.is_q8_bundle(tkw) == form.startswith("q8")
    for k, v in tkw.items():
        want = np.asarray(jkw[k])
        assert tuple(v.shape) == want.shape, k
        if v.dtype == torch.int8 or k == "emb_scale":
            assert np.array_equal(v.numpy(), want), k           # bit-equal
        else:
            np.testing.assert_allclose(_as_f64(v), _as_f64(want), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_plain_k1_matches_jax_scan(fused, q8):
    """K1's plain version vs the JAX package's step-by-step synthesis, at the
    bars and on the input recipe of tests/test_pallas_kernel.py:17-97 (one
    frame-net step from init; f32: >=98% exact PCM, gru_a within 2e-2; q8:
    >90%, 5e-2; RNG in lockstep). With live LPC the JAX package's own q8
    kernel differs from its scan by more than 5e-2 on a few streams, as the
    port does; test_plain_k1_matches_pallas_interpret holds the port to
    the JAX kernel there."""
    jf, tf = fused
    if q8:
        jf, tf = JQ.quantize_fused(jf), Q.quantize_fused(tf)
    kw = K.kernel_weights(tf, TCFG, dtype=torch.float32)
    ca, cb, lpc, s0 = _inputs(tf, 64, frames=1)
    n = 32
    st, pt = K.sample_loop_plain(kw, s0, ca, cb, lpc, n)
    js, jp = jax.jit(JM.synthesize_frame, static_argnames=("n_samples",))(
        jf, _jax_state(s0), ca.numpy(), cb.numpy(), lpc.numpy(), n_samples=n)
    same = np.mean(pt.numpy() == np.asarray(jp))
    assert same > (0.90 if q8 else 0.98), same
    t = sample_state_to_numpy(st)
    for f, x in zip(("z", "w", "jsr", "jcong"), js.rng):
        assert np.array_equal(t[f], np.asarray(x))
    np.testing.assert_allclose(t["gru_a"], np.asarray(js.gru_a),
                               atol=5e-2 if q8 else 2e-2)


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_plain_k1_matches_pallas_interpret(fused, monkeypatch, q8):
    """K1's plain version vs the TPU kernel itself, run by the Pallas
    interpreter on live-LPC inputs: B=8, n=16. Same arithmetic, so the bars
    are tight: >=98% exact PCM, RNG and excitation equal, gru_a within
    1e-4."""
    monkeypatch.setattr(JK, "_INTERPRET", True)
    jf, tf = fused
    if q8:
        jkw = JK.kernel_weights(JQ.quantize_fused(jf), JCFG)
        tkw = K.kernel_weights(Q.quantize_fused(tf), TCFG)
    else:
        jkw = JK.kernel_weights(jf, JCFG, dtype=jnp.float32)
        tkw = K.kernel_weights(tf, TCFG, dtype=torch.float32)
    ca, cb, lpc, s0 = _inputs(tf, 8, seed=12)
    n = 16
    js, jp = JK.synthesize_frame_pallas(jkw, _jax_state(s0), ca.numpy(),
                                        cb.numpy(), lpc.numpy(), JCFG,
                                        n_samples=n, bt=8)
    st, pt = K.sample_loop_plain(tkw, s0, ca, cb, lpc, n)
    assert np.mean(pt.numpy() == np.asarray(jp)) >= 0.98
    t = sample_state_to_numpy(st)
    assert np.array_equal(t["z"], np.asarray(js.rng.z))
    assert np.array_equal(t["last_exc"], np.asarray(js.last_exc))
    np.testing.assert_allclose(t["gru_a"], np.asarray(js.gru_a), atol=1e-4)


def test_wrapper_runs_plain_on_cpu_without_counting(fused):
    _, tf = fused
    kw = K.kernel_weights(tf, TCFG)
    ca, cb, lpc, s0 = _inputs(tf, 5)
    before = K.synthesize_frame_kernel.launches
    sw, pw = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 8)
    sp, pp = K.sample_loop_plain(kw, s0, ca, cb, lpc, 8)
    assert K.synthesize_frame_kernel.launches == before
    assert pw.shape == (5, 8) and torch.equal(pw, pp)
    assert all(torch.equal(a, b) for a, b in zip(sw.rng, sp.rng))
    assert torch.equal(sw.gru_a, sp.gru_a)


def test_wrapper_refuses_other_devices(fused):
    _, tf = fused
    kw = K.kernel_weights(tf, TCFG)
    ca, cb, lpc, s0 = _inputs(tf, 2)
    with pytest.raises(ValueError):
        K.synthesize_frame_kernel(kw, s0, ca.to("meta"), cb, lpc, 8)
