"""The batched causal PLC step of the port vs `lpcnet_tpu.plc.batched`, on
the CPU at a small size (the port's flags and its serving pool:
test_torch_plc_flags.py).

Both packages run the same numpy-seeded weights. The JAX package runs its
step-by-step (scan) sample-rate path here, the port its plain float32 model;
the kernel path is held in test_torch_plc_kernel_path.py. Concealed audio is
sampled, so a last-bit difference in a conditioning vector can flip a bit
of the sampling tree, after which that stream goes its own way: each frame
is held tightly from the JAX package's state carried across, and the
free-running trajectory loosely.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.plc import batched as JB

from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.plc import batched as B
from lpcnet_torch.weights.convert import (params_to_torch, plc_state_to_torch,
                                          state_to_numpy)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(rnn_units1=64, rnn_units2=16, cond_size=32)
JCFG, TCFG = JM.LPCNetConfig(**SMALL), M.LPCNetConfig(**SMALL)
N_FRAMES = 14
LOST = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],       # clean
    [0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0],       # loss, recovery, burst
    [0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0],       # periodic loss
    [0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0],       # long burst
], bool)
INT_FIELDS = ("pcm_fill", "skip_analysis", "loss_count", "fec_len", "fec_read",
              "fec_keep", "fec_skip", "blend", "feat_count")
VARIANTS = {"blend": dict(enable_blending=True),
            "codec": dict(enable_blending=False),
            "dc": dict(enable_blending=True, remove_dc=True)}


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


def _speech(batch, frames, dc=0.0):
    pcm = np.load(ROOT / "tests" / "fixtures" / "codec.npz")["pcm"].astype(np.float32)
    pcm = np.tile(pcm, frames * 160 // len(pcm) + 2)
    return np.stack([np.roll(pcm, 37 * i)[:frames * 160] for i in range(batch)]
                    ).reshape(batch, frames, 160) + dc


@pytest.fixture(scope="module")
def models():
    """(JAX fused, JAX PLC params, port fused, port PLC params)."""
    p = _numpy_tree(M.init_params(TCFG, seed=0))
    pp = _numpy_tree(PM.init_params(seed=1))
    return (JM.fuse_inference_params(jax.tree.map(jnp.asarray, p), JCFG),
            jax.tree.map(jnp.asarray, pp),
            M.fuse_inference_params(params_to_torch(p), TCFG),
            params_to_torch(pp))


def _fec_rows(k):
    """Two queued rows every other frame, for stream 1 only; the other
    streams' queues are left alone."""
    rs = np.random.RandomState(100 + k)
    return [(rs.normal(size=(4, 20)) * 0.3).astype(np.float32) for _ in range(2)]


_FEC_HAVE = np.array([False, True, False, False])


def _feed_fec(plc, k):
    if k % 2 == 0:
        for row in _fec_rows(k):
            plc.fec_add(row, have=_FEC_HAVE, unknown=np.zeros(4, bool))


_RUNS = {}


def _variant_run(models, name):
    """One run of the JAX package per variant (its step compiles once),
    shared by the tests: the state before every frame and every output; and
    beside it the port's frame from each of those states, and the port's own
    free run."""
    if name in _RUNS:
        return _RUNS[name]
    jf, jpp, tf, tpp = models
    kw = VARIANTS[name]
    pcm = _speech(4, N_FRAMES, dc=300.0 if name == "dc" else 0.0)
    jp = JB.BatchedPLC(jf, JCFG, jpp, batch=4, **kw)
    shared = B.BatchedPLC(tf, TCFG, tpp, batch=4, device="cpu", **kw)
    free = B.BatchedPLC(tf, TCFG, tpp, batch=4, device="cpu", **kw)
    assert shared.kw is None and not shared.use_kernel
    rec = dict(jout=[], tout=[], fout=[], jstate=[], tstate=[], fstate=[])
    for k in range(N_FRAMES):
        for plc in (jp, free):
            _feed_fec(plc, k)
        shared.state = plc_state_to_torch(jp.state)
        rec["jout"].append(jp.step(pcm[:, k], LOST[:, k]))
        rec["tout"].append(shared.step(pcm[:, k], LOST[:, k]))
        rec["fout"].append(free.step(pcm[:, k], LOST[:, k]))
        rec["jstate"].append(state_to_numpy(plc_state_to_torch(jp.state)))
        rec["tstate"].append(state_to_numpy(shared.state))
        rec["fstate"].append(state_to_numpy(free.state))
    rec["pcm"] = pcm
    _RUNS[name] = rec
    return rec


@pytest.mark.parametrize("name", list(VARIANTS))
def test_good_streams_pass_through(models, name):
    """A stream that never loses a frame gets its audio back: exactly
    without the DC filter, within 1 with it (the filter subtracts a rounded
    estimate and adds it back in float32), as in the JAX package."""
    rec = _variant_run(models, name)
    for k in range(N_FRAMES):
        want = np.clip(rec["pcm"][0, k], -32768, 32767)
        for out in (rec["tout"][k], rec["fout"][k]):
            assert out.shape == (4, 160) and out.dtype == np.float32
            if name == "dc":
                np.testing.assert_allclose(out[0], want, atol=1.0)
            else:
                assert np.array_equal(out[0], want)
        assert np.array_equal(rec["tout"][k][0], rec["jout"][k][0]) or name == "dc"


@pytest.mark.parametrize("name", list(VARIANTS))
def test_each_frame_from_the_jax_state_matches_jax(models, name):
    """Frame by frame, the port stepping from the JAX package's state: the
    integer state (queue fill, skip and loss counters, FEC pointers, blend
    flag, deferred-frame count) exact; frame-network conditioning within
    1e-4; the PLC net's state within 5e-4 and the features, its output,
    within 2e-4 (its input holds the Burg cepstra, which the two packages'
    float32 recursions give 2e-3 apart at worst; measured 2.5e-4 and
    6.2e-5); audio within 1 LSB with at most 2 % of a frame's
    samples off by more than 1e-3 (the JAX package's bar between two of its
    own graphs; the DC variant 2 and 5 %, as there)."""
    rec = _variant_run(models, name)
    max_d, max_frac = (2.0, 0.05) if name == "dc" else (1.0, 0.02)
    for k in range(N_FRAMES):
        js, ts = rec["jstate"][k], rec["tstate"][k]
        for f in INT_FIELDS:
            assert np.array_equal(js[f], ts[f]), (k, f)
        assert np.array_equal(js["fstate"]["frame_count"], ts["fstate"]["frame_count"])
        for f in ("cond_a", "cond_b"):
            np.testing.assert_allclose(ts[f], js[f], atol=1e-4, err_msg=f"{k} {f}")
        np.testing.assert_allclose(ts["features"], js["features"], atol=2e-4)
        np.testing.assert_allclose(ts["lpc"], js["lpc"], atol=1e-3)
        for g in ("gru1", "gru2"):
            np.testing.assert_allclose(ts["plc_net"][g], js["plc_net"][g], atol=5e-4)
            np.testing.assert_allclose(ts["plc_ring"][g], js["plc_ring"][g], atol=5e-4)
        np.testing.assert_allclose(ts["fstate"]["conv2_mem"], js["fstate"]["conv2_mem"],
                                   atol=1e-4)
        for f in ("z", "w", "jsr", "jcong"):
            assert np.array_equal(ts["sstate"]["rng"][f], js["sstate"]["rng"][f]), (k, f)
        d = np.abs(rec["tout"][k] - rec["jout"][k])
        assert d.max() <= max_d, (k, d.max())
        assert (d > 1e-3).mean() < max_frac, (k, (d > 1e-3).mean())
    # the variants did what they are for
    fills = np.stack([s["pcm_fill"] for s in rec["jstate"]])
    assert fills.min() == 0 and (fills == 240).any()      # drained, requeued
    assert rec["jstate"][9]["loss_count"].max() >= 2
    assert np.stack([s["fec_read"] for s in rec["jstate"]])[:, 1].max() > 0
    if name == "dc":
        assert abs(rec["tstate"][-1]["dc_mem"][0] - 300.0) < 100.0


@pytest.mark.parametrize("name", list(VARIANTS))
def test_free_running_trajectory_matches_jax(models, name):
    """The port on its own state over the 14 frames: integer state and RNG
    words equal to the JAX package's at every frame (they do not depend on
    sampled values); audio loosely: at least 85 % of all samples within 1
    LSB, since a stream whose sampling tree flips one bit departs for the
    rest of that loss (measured: one of the eight lost stretches)."""
    rec = _variant_run(models, name)
    close = []
    for k in range(N_FRAMES):
        js, fs = rec["jstate"][k], rec["fstate"][k]
        for f in INT_FIELDS:
            assert np.array_equal(js[f], fs[f]), (k, f)
        for f in ("z", "w", "jsr", "jcong"):
            assert np.array_equal(fs["sstate"]["rng"][f], js["sstate"]["rng"][f]), (k, f)
        assert np.isfinite(rec["fout"][k]).all()
        close.append(np.abs(rec["fout"][k] - rec["jout"][k]) <= 1.0)
    assert np.mean(close) >= 0.85, np.mean(close)
