"""lpcnet_torch's vocoder model vs the JAX package on a small config, CPU.

Weights come from numpy (the port's RandomState init) and reach both
packages as numpy arrays, the port's through weights.convert; features,
waveforms and states come from numpy seeds too. (test_torch_cref.py carries
jax.random weights across.)
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.nn import quantized as JQ
from lpcnet_tpu.weights import checkpoint as JC
from lpcnet_tpu.weights.checkpoint import flatten_tree as jflatten

from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.nn import quantized as Q
from lpcnet_torch.weights import checkpoint as TC
from lpcnet_torch.weights.checkpoint import flatten_tree
from lpcnet_torch.weights.convert import (params_to_torch,
                                          sample_state_to_numpy,
                                          sample_state_to_torch)

# the plain path is many small ops: one intra-op thread per process keeps
# parallel pytest workers from oversubscribing the cores
torch.set_num_threads(1)

SMALL = dict(rnn_units1=64, rnn_units2=16, cond_size=32, pitch_embed_dim=8)


def _cfgs(**kw):
    return JM.LPCNetConfig(**SMALL, **kw), M.LPCNetConfig(**SMALL, **kw)


def _feats(b, frames, seed):
    rs = np.random.RandomState(seed)
    f = (rs.normal(size=(frames, b, 36)) * 0.3).astype(np.float32)
    f[..., 18] = rs.uniform(-0.5, 0.5, (frames, b))
    return f


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


@functools.lru_cache(maxsize=None)
def _params():
    """One seeded init for the module, as numpy (the variants below change
    no parameter shape)."""
    return _numpy_tree(M.init_params(_cfgs()[1], seed=0))


def _models(**kw):
    jcfg, tcfg = _cfgs(**kw)
    params = _params()
    jf = JM.fuse_inference_params(jax.tree.map(jnp.asarray, params), jcfg)
    tf = M.fuse_inference_params(params_to_torch(params), tcfg)
    return jcfg, tcfg, jf, tf


_jframe = jax.jit(JM.frame_network, static_argnames=("cfg",))
_jsynth = jax.jit(JM.synthesize_frame, static_argnames=("n_samples",))


def _conditioning(jcfg, tcfg, jf, tf, b, frames=3, seed=7):
    """Run both frame networks `frames` times; return the last outputs."""
    feats = _feats(b, frames, seed)
    js, ts = JM.init_frame_state(b, jcfg), M.init_frame_state(b, tcfg)
    for k in range(frames):
        js, jc, jca, jcb, jlpc = _jframe(jf, js, feats[k], cfg=jcfg)
        ts, tc, tca, tcb, tlpc = M.frame_network(tf, ts,
                                                 torch.from_numpy(feats[k]), tcfg)
    return (js, jc, jca, jcb, jlpc), (ts, tc, tca, tcb, tlpc)


def test_init_params_layout_matches_jax():
    jcfg, tcfg = _cfgs()
    abstract = jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                              jax.random.PRNGKey(0))
    jshapes = {"/".join(p.key for p in path): tuple(leaf.shape) for path, leaf
               in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    a = flatten_tree(M.init_params(tcfg, seed=3))
    assert {k: v.shape for k, v in a.items()} == jshapes
    b = flatten_tree(M.init_params(tcfg, seed=3))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    rec = a["gru_a/recurrent"][:, :64]          # orthogonal gate block
    np.testing.assert_allclose(rec.T @ rec, np.eye(64), atol=1e-5)


def test_fuse_inference_params_matches_jax():
    _, _, jf, tf = _models()
    jflat, tflat = jflatten(jf), flatten_tree(tf)
    assert set(tflat) <= set(jflat)
    for k, v in tflat.items():
        np.testing.assert_allclose(v, jflat[k], rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("variant", [{}, {"e2e": True, "lpc_gamma": 0.9},
                                     {"lookahead": 0}],
                         ids=["default", "e2e_gamma", "lookahead0"])
def test_frame_network_matches_jax(variant):
    jcfg, tcfg, jf, tf = _models(**variant)
    (js, jc, jca, jcb, jlpc), (ts, tc, tca, tcb, tlpc) = _conditioning(
        jcfg, tcfg, jf, tf, b=8, frames=4)
    for want, got in ((jc, tc), (jca, tca), (jcb, tcb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(tlpc.numpy(), np.asarray(jlpc), atol=1e-4)
    assert np.abs(np.asarray(jlpc)).max() > 0
    for f in ("conv1_mem", "conv2_mem", "old_lpc"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-5,
                                   atol=1e-4, err_msg=f)
    assert np.array_equal(ts.frame_count.numpy(), np.asarray(js.frame_count))


def _synth_pair(q8, b=64, n=32, preload=None):
    jcfg, tcfg, jf, tf = _models()
    (_, _, jca, jcb, jlpc), (_, _, tca, tcb, tlpc) = _conditioning(
        jcfg, tcfg, jf, tf, b)
    if q8:
        jf, tf = JQ.quantize_fused(jf), Q.quantize_fused(tf)
    js0 = JM.init_sample_state(b, jcfg)
    ts0 = M.init_sample_state(b, tcfg)
    js, jp = _jsynth(jf, js0, jca, jcb, jlpc, n_samples=n, preload=preload)
    ts, tp = M.synthesize_frame(
        tf, ts0, tca, tcb, tlpc, n_samples=n,
        preload=None if preload is None else torch.from_numpy(preload))
    return (js, np.asarray(jp)), (ts, tp.numpy()), (jf, tf)


def test_synthesize_frame_f32_matches_jax():
    (js, jp), (ts, tp), _ = _synth_pair(q8=False)
    assert np.mean(jp == tp) >= 0.98
    t = sample_state_to_numpy(ts)
    assert all(np.array_equal(t[f], np.asarray(x))
               for f, x in zip(("z", "w", "jsr", "jcong"), js.rng))
    np.testing.assert_allclose(t["gru_a"], np.asarray(js.gru_a), atol=2e-2)


def test_synthesize_frame_q8_matches_jax():
    (js, jp), (ts, tp), (jf, tf) = _synth_pair(q8=True)
    for k in ("recurrent_q8", "recurrent_diag"):
        assert np.array_equal(tf["gru_a_rec"][k].numpy(),
                              np.asarray(jf["gru_a_rec"][k]))
    assert np.array_equal(tf["gru_b_in_q8"].numpy(), np.asarray(jf["gru_b_in_q8"]))
    assert np.array_equal(tf["gru_b_rec"]["recurrent_q8"].numpy(),
                          np.asarray(jf["gru_b_rec"]["recurrent_q8"]))
    assert np.mean(jp == tp) > 0.90
    t = sample_state_to_numpy(ts)
    assert np.array_equal(t["z"], np.asarray(js.rng.z))
    np.testing.assert_allclose(t["gru_a"], np.asarray(js.gru_a), atol=5e-2)


def test_preload_states_match_jax():
    """Teacher forcing removes the sampler's chaos: every state field tracks
    JAX within 1e-4 (the u-law excitation exactly). The q8 teacher-forced
    path is held against the C reference in test_torch_cref.py."""
    b, n = 16, 32
    preload = (np.random.RandomState(5).normal(size=(b, n)) * 2000
               ).astype(np.float32)
    (js, jp), (ts, tp), _ = _synth_pair(q8=False, b=b, n=n, preload=preload)
    t = sample_state_to_numpy(ts)
    for f in ("gru_a", "gru_b", "last_sig", "deemph"):
        np.testing.assert_allclose(t[f], np.asarray(getattr(js, f)),
                                   rtol=1e-5, atol=1e-4, err_msg=f)
    assert np.array_equal(t["last_exc"], np.asarray(js.last_exc))
    np.testing.assert_allclose(tp, jp, atol=1e-4)


def test_sample_state_carry_roundtrip():
    jcfg, tcfg = _cfgs()
    js = JM.init_sample_state(5, jcfg)
    ts = sample_state_to_torch(js)
    assert ts.last_exc.dtype == torch.int32
    back = sample_state_to_numpy(ts)
    assert np.array_equal(back["jsr"], np.asarray(js.rng.jsr))
    ref = M.init_sample_state(5, tcfg)
    assert all(torch.equal(a, b) for a, b in zip(ts.rng, ref.rng))


def test_config_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(M.LPCNetConfig)]
            == [f.name for f in dataclasses.fields(JM.LPCNetConfig)])
    assert dataclasses.asdict(M.LPCNetConfig()) == dataclasses.asdict(
        JM.LPCNetConfig())


def test_checkpoint_roundtrip_between_packages(tmp_path):
    """npz written by either package loads in the other, value for value,
    config included."""
    jcfg, tcfg = _cfgs(lookahead=1)
    params = M.init_params(tcfg, seed=9)
    TC.save_checkpoint(str(tmp_path / "port.npz"), params, tcfg)
    jp, jc = JC.load_checkpoint(str(tmp_path / "port.npz"))
    assert jc == jcfg
    jflat, tflat = jflatten(jp), flatten_tree(params)
    assert set(jflat) == set(tflat)
    assert all(np.array_equal(jflat[k], tflat[k]) for k in tflat)
    JC.save_checkpoint(str(tmp_path / "jax.npz"), jp, jcfg)
    back, bc = TC.load_checkpoint(str(tmp_path / "jax.npz"))
    assert bc == tcfg
    assert all(np.array_equal(v, tflat[k]) for k, v in flatten_tree(back).items())
