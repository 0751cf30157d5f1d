"""The batched PLC's kernel program (the teacher-forced drain through K3, two
masked half-frames through K2) at full width vs the JAX package's kernel
path, its Pallas kernels run by the interpreter: blending on, 8 streams; and
the program with the PLC-net chain (K4; `BatchedPLC(chain=True)`) against
the JAX package's `fastchain` path, blending on and off, with FEC rows
queued. The port runs the kernels' plain versions (CPU tensors). Both sides
take the float32 operand bundle in place of their bfloat16 default, so that
a frame can be held tightly: with bfloat16 operands a last-bit difference
flips an operand by 2^-8 and the sampled streams part within a frame."""

import os

os.environ["LPCNET_PALLAS_INTERPRET"] = "1"  # before the JAX kernels import

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.kernels import plc_chain as JPC
from lpcnet_tpu.kernels import sample_loop as JK
from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.plc import batched as JB

from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.plc import batched as B
from lpcnet_torch.weights.convert import (params_to_torch, plc_state_to_torch,
                                          state_to_numpy)

torch.set_num_threads(1)

BATCH, N_FRAMES = 8, 10
INT_FIELDS = ("pcm_fill", "skip_analysis", "loss_count", "fec_len", "fec_read",
              "fec_keep", "fec_skip", "blend", "feat_count")


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


def _run_both(chain=False, enable_blending=True, fec=False, frames=N_FRAMES):
    """The JAX kernel path frame by frame, and the port's frame from each of
    its states; with `chain` the JAX package's `fastchain` path against the
    port's `chain=True`; with `fec` FEC rows queued for a third of the
    streams on both sides before the first frame."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JK, "_INTERPRET", True)
        mp.setattr(JPC, "_INTERPRET", True)
        mp.setattr(JB, "_FASTCHAIN", chain)    # read when the JAX step traces
        jcfg, tcfg = JM.LPCNetConfig(), M.LPCNetConfig()
        p = _numpy_tree(M.init_params(tcfg, seed=0))
        pp = _numpy_tree(PM.init_params(seed=1))
        jf = JM.fuse_inference_params(jax.tree.map(jnp.asarray, p), jcfg)
        tf = M.fuse_inference_params(params_to_torch(p), tcfg)
        jp = JB.BatchedPLC(jf, jcfg, jax.tree.map(jnp.asarray, pp), batch=BATCH,
                           use_kernel=True, enable_blending=enable_blending)
        tp = B.BatchedPLC(tf, tcfg, params_to_torch(pp), batch=BATCH,
                          device="cpu", use_kernel=True,
                          enable_blending=enable_blending, chain=chain)
        assert tp.kw["emb_cat"].dtype == torch.bfloat16
        assert JB._FASTTF and (tp._cw is not None) == chain
        jp.kw = JK.kernel_weights(jf, jcfg, dtype=jnp.float32)
        tp.kw = K.kernel_weights(tf, tcfg, dtype=torch.float32)
        rs = np.random.RandomState(0)
        pcm = (rs.randn(BATCH, frames, 160) * 2000).astype(np.float32)
        lost = np.zeros((BATCH, frames), bool)
        lost[:4, 4] = True        # a loss and its recovery on half the batch
        lost[:2, 5] = True        # a double loss
        lost[6, 6:8] = True
        if fec:
            have = np.arange(BATCH) % 3 == 0
            for row in (rs.randn(4, 20) * 0.2).astype(np.float32):
                jp.fec_add(np.tile(row, (BATCH, 1)), have=have)
        rec = dict(pcm=pcm, lost=lost, jout=[], tout=[], jstate=[], tstate=[])
        for k in range(frames):
            tp.state = plc_state_to_torch(jp.state)
            rec["jout"].append(jp.step(pcm[:, k], lost[:, k]))
            rec["tout"].append(tp.step(pcm[:, k], lost[:, k]))
            rec["jstate"].append(state_to_numpy(plc_state_to_torch(jp.state)))
            rec["tstate"].append(state_to_numpy(tp.state))
        rec["stats"] = tp.stats
        return rec
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def run():
    return _run_both()


def test_kernel_path_good_streams_pass_through(run):
    good = ~run["lost"].any(axis=1)
    assert good.sum() == 3
    for k in range(N_FRAMES):
        want = np.clip(run["pcm"][good, k], -32768, 32767)
        assert np.array_equal(run["tout"][k][good], want)
        assert np.array_equal(run["jout"][k][good], want)
    # 8 streams: below the floor of compaction, every frame at the full batch
    assert run["stats"] == {"compacted": 0, "overflowed": 0, "full": N_FRAMES}


def _each_frame_matches(run):
    for k in range(len(run["jout"])):
        js, ts = run["jstate"][k], run["tstate"][k]
        for f in INT_FIELDS:
            assert np.array_equal(js[f], ts[f]), (k, f)
        for f in ("z", "w", "jsr", "jcong"):
            assert np.array_equal(ts["sstate"]["rng"][f], js["sstate"]["rng"][f]), (k, f)
        for f in ("cond_a", "cond_b"):
            np.testing.assert_allclose(ts[f], js[f], atol=1e-4, err_msg=f"{k} {f}")
        np.testing.assert_allclose(ts["features"], js["features"], atol=2e-4)
        for g in ("gru1", "gru2"):
            np.testing.assert_allclose(ts["plc_net"][g], js["plc_net"][g], atol=5e-4)
        for f in ("gru_a", "gru_b"):
            np.testing.assert_allclose(ts["sstate"][f], js["sstate"][f], atol=2e-2,
                                       err_msg=f"{k} {f}")
        d = np.abs(run["tout"][k] - run["jout"][k])
        assert (d <= 1.0).mean() >= 0.98, (k, (d <= 1.0).mean())
        close = np.abs(ts["sstate"]["last_sig"] - js["sstate"]["last_sig"]) <= 1.0
        assert close.mean() >= 0.98, (k, close.mean())
    assert any(s["pcm_fill"].min() == 0 for s in run["jstate"])
    assert max(s["loss_count"].max() for s in run["jstate"]) == 2


def test_kernel_path_each_frame_matches_jax(run):
    """From the JAX package's state, every frame: integer state and RNG
    words exact; conditioning within 1e-4, features within 2e-4 and PLC-net
    state within 5e-4 (Burg, see test_torch_plc_batched.py); GRU-A and GRU-B of the sample
    state within 2e-2 and the signal state within 1 (the JAX package's bars
    for K3 and K2 against its scan); audio within 1 LSB on at least 98 % of
    a frame's samples."""
    _each_frame_matches(run)


@pytest.mark.parametrize("enable_blending", [True, False],
                         ids=["blending", "codec"])
def test_chain_path_each_frame_matches_jax(enable_blending):
    """The chain (K4's plain version against the TPU kernel interpreted)
    with FEC rows queued, from the JAX package's state every frame, to the
    bars of the program without it; the FEC pointers moved and the queue
    read on both sides alike."""
    got = _run_both(chain=True, enable_blending=enable_blending, fec=True,
                    frames=8)
    _each_frame_matches(got)
    assert max(s["fec_read"].max() for s in got["jstate"]) > 0
