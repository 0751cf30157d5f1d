"""The port's batched non-causal PLC step and the two-path steps against
`lpcnet_tpu.plc.batched`, on the CPU at a small size (Na=64, Nb=16, cond 32),
on the step-by-step float32 model: each frame from the JAX package's state,
and the free run. The port's own oracles (its host PLC, the two-path step,
per-stream independence) and the non-causal pool are held in
test_torch_plc_nc_host.py, the kernel program in
test_torch_plc_nc_kernel_path.py.

Concealed audio is sampled, so a last-bit difference in a conditioning
vector can flip a bit of the sampling tree and set that stream its own way:
each frame is held tightly from the JAX package's state carried across, and
the free-running trajectory loosely (as test_torch_plc_batched.py does).
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
N_FRAMES = 14
LOST = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],       # clean
    [0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0],       # loss, recovery, burst
    [0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0],       # periodic loss
    [0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0],       # long burst
], bool)
# (lookahead, BatchedPLC keywords)
VARIANTS = {"nc": (0, dict(non_causal=True)),
            "nc_dc": (0, dict(non_causal=True, remove_dc=True)),
            "nc_two_path": (0, dict(non_causal=True, fused_step=False)),
            "causal_two_path": (2, dict(fused_step=False))}
NC_INT_FIELDS = ("loss_count", "queued")
CAUSAL_INT_FIELDS = ("pcm_fill", "skip_analysis", "loss_count", "blend",
                     "feat_count")


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
def weights():
    """numpy-seeded weights as numpy (vocoder params, PLC params)."""
    return (_numpy_tree(M.init_params(M.LPCNetConfig(**SMALL), seed=0)),
            _numpy_tree(PM.init_params(seed=1)))


def _port(weights, lookahead=0):
    p, pp = weights
    cfg = M.LPCNetConfig(**SMALL, lookahead=lookahead)
    return M.fuse_inference_params(params_to_torch(p), cfg), params_to_torch(pp), cfg


_RUNS = {}


def _variant_run(weights, name):
    """One run of the JAX package per variant (its step compiles once): its
    state before every frame and every output; beside it the port's frame
    from each of those states, and the port's own free run."""
    if name in _RUNS:
        return _RUNS[name]
    la, kw = VARIANTS[name]
    p, pp = weights
    jcfg = JM.LPCNetConfig(**SMALL, lookahead=la)
    jp = JB.BatchedPLC(JM.fuse_inference_params(jax.tree.map(jnp.asarray, p), jcfg),
                       jcfg, jax.tree.map(jnp.asarray, pp), batch=4, **kw)
    tf, tpp, tcfg = _port(weights, la)
    shared = B.BatchedPLC(tf, tcfg, tpp, batch=4, device="cpu", **kw)
    free = B.BatchedPLC(tf, tcfg, tpp, batch=4, device="cpu", **kw)
    assert shared.kw is None
    pcm = _speech(4, N_FRAMES, dc=300.0 if kw.get("remove_dc") else 0.0)
    rec = dict(jout=[], tout=[], fout=[], jstate=[], tstate=[], fstate=[], pcm=pcm)
    for k in range(N_FRAMES):
        shared.state = plc_state_to_torch(jp.state)
        rec["jout"].append(jp.step(pcm[:, k], LOST[:, k]))
        rec["tout"].append(shared.step(pcm[:, k], LOST[:, k]))
        rec["fout"].append(free.step(pcm[:, k], LOST[:, k]))
        rec["jstate"].append(state_to_numpy(plc_state_to_torch(jp.state)))
        rec["tstate"].append(state_to_numpy(shared.state))
        rec["fstate"].append(state_to_numpy(free.state))
    _RUNS[name] = rec
    return rec


def _int_fields(name):
    return NC_INT_FIELDS if name.startswith("nc") else CAUSAL_INT_FIELDS


@pytest.mark.parametrize("name", list(VARIANTS))
def test_good_streams_pass_through(weights, name):
    """A stream that never loses a frame gets its audio back: the
    non-causal modes 80 samples late (within 1 with the DC filter, which
    subtracts a rounded estimate and adds it back in float32)."""
    rec = _variant_run(weights, name)
    nc = name.startswith("nc")
    flat = rec["pcm"][0].reshape(-1)
    for k in range(N_FRAMES):
        if nc:
            want = (np.concatenate([np.zeros(80, np.float32), flat])[k * 160:(k + 1) * 160]
                    if k else None)
        else:
            want = rec["pcm"][0, k]
        for out in (rec["tout"][k], rec["fout"][k]):
            assert out.shape == (4, 160) and out.dtype == np.float32
            if want is None:
                continue
            if name == "nc_dc":
                np.testing.assert_allclose(out[0], want, atol=1.0)
            else:
                assert np.array_equal(out[0], want), k


@pytest.mark.parametrize("name", list(VARIANTS))
def test_each_frame_from_the_jax_state_matches_jax(weights, name):
    """Frame by frame, the port stepping from the JAX package's state: the
    integer state exact and the RNG words equal; conditioning within 1e-4,
    features within 2e-4, the PLC net's state within 5e-4 (Burg, see
    test_torch_plc_batched.py); audio within 1 LSB with at most 2 % of a
    frame's samples off by more than 1e-3 (the DC variant 2 and 5 %), as
    test_torch_plc_batched.py holds the causal step."""
    rec = _variant_run(weights, name)
    max_d, max_frac = (2.0, 0.05) if name == "nc_dc" else (1.0, 0.02)
    for k in range(N_FRAMES):
        js, ts = rec["jstate"][k], rec["tstate"][k]
        for f in _int_fields(name):
            assert np.array_equal(js[f], ts[f]), (k, f)
        assert np.array_equal(js["fstate"]["frame_count"], ts["fstate"]["frame_count"])
        for f in ("z", "w", "jsr", "jcong"):
            assert np.array_equal(ts["sstate"]["rng"][f], js["sstate"]["rng"][f]), (k, f)
        for f in ("cond_a", "cond_b"):
            np.testing.assert_allclose(ts[f], js[f], atol=1e-4, err_msg=f"{k} {f}")
        np.testing.assert_allclose(ts["features"], js["features"], atol=2e-4)
        for g in ("gru1", "gru2"):
            np.testing.assert_allclose(ts["plc_net"][g], js["plc_net"][g], atol=5e-4)
        d = np.abs(rec["tout"][k] - rec["jout"][k])
        assert d.max() <= max_d, (k, d.max())
        assert (d > 1e-3).mean() < max_frac, (k, (d > 1e-3).mean())
    if name.startswith("nc"):
        # recoveries queued their resync, and a burst counted its losses
        assert any(s["queued"].any() for s in rec["jstate"])
        assert rec["jstate"][10]["loss_count"].max() == 5
    if name == "nc_dc":
        assert abs(rec["tstate"][-1]["dc_mem"][0] - 300.0) < 100.0


@pytest.mark.parametrize("name", list(VARIANTS))
def test_free_running_trajectory_matches_jax(weights, name):
    """The port on its own state: integer state and RNG words equal to the
    JAX package's at every frame; audio loosely, at least 85 % of all
    samples within 1 LSB."""
    rec = _variant_run(weights, name)
    close = []
    for k in range(N_FRAMES):
        js, fs = rec["jstate"][k], rec["fstate"][k]
        for f in _int_fields(name):
            assert np.array_equal(js[f], fs[f]), (k, f)
        for f in ("z", "w", "jsr", "jcong"):
            assert np.array_equal(fs["sstate"]["rng"][f], js["sstate"]["rng"][f]), (k, f)
        assert np.isfinite(rec["fout"][k]).all()
        close.append(np.abs(rec["fout"][k] - rec["jout"][k]) <= 1.0)
    assert np.mean(close) >= 0.85, np.mean(close)
