"""The batched non-causal PLC step's kernel program (the deferred resync and
the good streams' resync through K3, the lost and recovering streams'
section: K2, K3 in reverse time, K2) on the kernels' plain versions (CPU
tensors): compaction on against off, the program against the step-by-step
model, its calls and their shapes, the compaction's sentinel rows, the
restored recovery rows; and at full width against the JAX package's kernel
path with its Pallas kernels interpreted, both sides on the float32 operand
bundle (as test_torch_plc_kernel_path.py does for the causal step)."""

import os

os.environ["LPCNET_PALLAS_INTERPRET"] = "1"  # before the JAX kernels import

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

SMALL = M.LPCNetConfig(rnn_units1=64, rnn_units2=16, cond_size=32, lookahead=0)


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def models():
    return (M.fuse_inference_params(M.init_params(SMALL, seed=0), SMALL),
            PM.init_params(seed=1))


def _make(models, b, use_kernel=True, **kw):
    tf, tpp = models
    return B.BatchedPLC(tf, SMALL, tpp, batch=b, non_causal=True, device="cpu",
                        use_kernel=use_kernel, **kw)


def _traffic(b, frames, seed, dense_frame=None):
    rs = np.random.RandomState(seed)
    pcm = (rs.randn(b, frames, 160) * 2000).astype(np.float32)
    lost = rs.rand(b, frames) < 0.2
    if dense_frame is not None:
        lost[:, dense_frame] = rs.rand(b) < 0.9
    lost[0] = False
    return pcm, lost


def test_section_compaction_matches_full(models):
    """test_plc_batched.py:508 on the port: the compacted L|rec section and
    deferred resync against the full-batch program (compaction pinned to 8
    of 16 streams against off); sparse frames compact, a dense one
    overflows. Stream 0 never loses a frame: its audio and sample state
    exact both ways; integer state equal; features within 2e-4; audio more
    than 2 apart on under 2 % of samples; the sample state's floats within
    1e-5 of their scale on over 85 % of entries and within 2 % of it
    everywhere (concealment feeds synthesised audio back into analysis, so
    a flipped sampler bit moves a few rows)."""
    pcm, lost = _traffic(16, 10, 7, dense_frame=5)

    def run(cap):
        plc = _make(models, 16)
        plc.compact_cap = cap
        return plc.run(pcm, lost), state_to_numpy(plc.state), plc.stats

    out_c, st_c, stats_c = run(8)
    out_r, st_r, stats_r = run(0)
    assert stats_c["compacted"] > 0 and stats_c["overflowed"] > 0
    assert stats_r == {"compacted": 0, "overflowed": 0, "full": 10}
    assert np.array_equal(out_c[0], out_r[0])
    d = np.abs(out_c.astype(np.float64) - out_r)
    assert (d > 2).mean() < 0.02, (d > 2).mean()
    for f in ("loss_count", "queued"):
        assert np.array_equal(st_c[f], st_r[f]), f
    np.testing.assert_allclose(st_c["features"], st_r["features"], atol=2e-4)
    for f in ("gru_a", "gru_b", "last_sig", "last_exc", "deemph"):
        lc, lr = st_c["sstate"][f], st_r["sstate"][f]
        assert np.array_equal(lc[0], lr[0]), f
        if np.issubdtype(lc.dtype, np.floating):
            scale = max(1.0, np.abs(lr).max())
            dd = np.abs(lc.astype(np.float64) - lr)
            assert (dd > 1e-5 * scale).mean() < 0.15, f
            assert dd.max() <= 0.02 * scale, (f, dd.max(), scale)
        else:
            assert np.array_equal(lc, lr), f
    for f in ("z", "w", "jsr", "jcong"):
        assert np.array_equal(st_c["sstate"]["rng"][f], st_r["sstate"]["rng"][f])


def test_kernel_program_matches_scan(models):
    """test_plc_batched.py:571 on the port: the kernel program (plain
    versions, float32 operands) against the step-by-step model: streams
    untouched by loss and the frames before the first loss exact;
    concealment more than 2 apart on under 5 % of samples."""
    b = 8
    rs = np.random.RandomState(3)
    pcm = (rs.randn(b, 10, 160) * 2000).astype(np.float32)
    lost = np.zeros((b, 10), bool)
    lost[:4, 4] = True            # a loss, its recovery and deferred resync
    lost[:2, 5] = True            # a double loss
    k_plc = _make(models, b)
    k_plc.kw = K.kernel_weights(k_plc.fused, SMALL, dtype=torch.float32)
    out_k = k_plc.run(pcm, lost)
    out_s = _make(models, b, use_kernel=False).run(pcm, lost)
    assert np.array_equal(out_k[4:], out_s[4:])
    assert np.array_equal(out_k[:, :4], out_s[:, :4])
    d = np.abs(out_k.astype(np.float64) - out_s)
    assert (d > 2).mean() < 0.05, (d > 2).mean()


@pytest.mark.parametrize("remove_dc", [False, True], ids=["nc", "nc_dc"])
def test_kernel_calls_a_frame(models, monkeypatch, remove_dc):
    """A non-causal frame calls K2 twice and K3 three times, whatever its
    losses, with the DC filter (the full-batch program) or without (the
    compacted section): K3 on the deferred resync, K2, K3 in reverse time
    and K2 on the lost and recovering streams, K3 on the good streams'
    resync at the full batch. At 128 streams (capacity 32) every call but
    the last resync runs on the sub-batch; with the DC filter only the
    deferred resync does."""
    b, frames = 128, 4
    pcm, _ = _traffic(b, frames, 11)
    lost = np.zeros((b, frames), bool)
    lost[1:9, 1:3] = True         # a double loss, then its recovery
    lost[20:30, 2] = True
    seen = []
    monkeypatch.setattr(B, "kernel_tap", lambda name, args: seen.append(
        (name, args[1].gru_a.shape[0])))
    plc = _make(models, b, remove_dc=remove_dc)
    plc.run(pcm, lost)
    k2, k3 = "synthesize_frame_masked_kernel", "teacher_force_blocks_kernel"
    cap = plc.compact_cap
    assert cap == 32
    sub = b if remove_dc else cap
    assert seen == [(k3, cap), (k2, sub), (k3, sub), (k2, sub), (k3, b)] * frames
    assert plc.stats == ({"compacted": 0, "overflowed": 0, "full": 0} if remove_dc
                         else {"compacted": frames, "overflowed": 0, "full": 0})


def test_compaction_sentinel_rows():
    """`_compacted` hands the body `mask`'s rows and zero rows up to the
    capacity, and scatters only `mask`'s rows back: the sentinel rows'
    outputs go nowhere, the other rows keep `into`."""
    b = 256
    mask = torch.zeros(b, dtype=torch.bool)
    mask[[3, 100, 255]] = True
    x = torch.arange(b, dtype=torch.float32)[:, None] + 1.0
    got = {}

    def body(sec):
        got["x"] = sec["x"].clone()
        got["count"] = sec["count"].clone()
        return {"y": sec["x"] * 10.0 + 1.0}     # a sentinel row gives 1, not 0

    stats = {"compacted": 0, "overflowed": 0, "full": 0}
    count = torch.full((b,), 160, dtype=torch.int32) * mask
    cap = B._compact_capacity(b)
    out = B._compacted(body, {"x": x, "count": count}, mask,
                       {"y": torch.full((b, 1), -5.0)}, cap, stats)
    assert stats["compacted"] == 1 and got["x"].shape == (cap, 1)
    assert got["x"][:3, 0].tolist() == [4.0, 101.0, 256.0]
    assert not got["x"][3:].any() and not got["count"][3:].any()
    want = torch.full((b, 1), -5.0)
    want[mask] = x[mask] * 10.0 + 1.0
    assert torch.equal(out["y"], want)
    many = torch.ones(b, dtype=torch.bool)
    B._compacted(body, {"x": x, "count": count}, many, {"y": x}, cap, stats)
    assert stats["overflowed"] == 1 and got["x"].shape == (b, 1)


def _leaves(t):
    if isinstance(t, tuple):
        for x in t:
            yield from _leaves(x)
    else:
        yield t


def test_recovery_rows_restored_bit_for_bit(models):
    """A recovering stream's section (forward tail, frame net, reverse-time
    resynthesis from a fresh state, reverse tail) is undone at the end of
    its frame: its frame state, conditioning, LPC and sample state leave
    the frame bit-equal to how they entered it, compacted or not; only the
    buffer head, the queued resync and the analysis state move on."""
    pcm, _ = _traffic(128, 6, 13)
    lost = np.zeros((128, 6), bool)
    lost[1:6, 2:4] = True         # recovered at frame 4: queued at frame 5
    lost[10:16, 3:5] = True       # recovering at frame 5
    for compact in (True, False):
        plc = _make(models, 128)
        if not compact:
            plc.compact_cap = 0
        for k in range(5):
            plc.step(pcm[:, k], lost[:, k])
        before = plc.state
        rec = (before.loss_count > 0).numpy()
        assert rec.sum() == 6 and before.queued.numpy()[1:6].all()
        plc.step(pcm[:, 5], lost[:, 5])
        after = plc.state
        assert plc.stats["compacted" if compact else "full"] == 6
        rows = torch.from_numpy(rec)
        for name in ("fstate", "sstate", "cond_a", "cond_b", "lpc"):
            for x, y in zip(_leaves(getattr(before, name)),
                            _leaves(getattr(after, name))):
                assert torch.equal(x[rows], y[rows]), name
        assert after.queued.numpy()[rec].all()
        assert not np.array_equal(after.pcm_buf.numpy()[rec], before.pcm_buf.numpy()[rec])


# --------------------------------------------------------------------------
# Full width, against the JAX package's kernel path interpreted
# --------------------------------------------------------------------------

BATCH, N_FRAMES = 8, 8


@pytest.fixture(scope="module")
def full_run(request):
    """The JAX kernel path frame by frame, and the port's frame from each of
    its states; the non-causal mode at LPCNetConfig(lookahead=0)."""
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    mp.setattr(JK, "_INTERPRET", True)
    jcfg, tcfg = JM.LPCNetConfig(lookahead=0), M.LPCNetConfig(lookahead=0)
    p = _numpy_tree(M.init_params(tcfg, seed=0))
    pp = _numpy_tree(PM.init_params(seed=1))
    jf = JM.fuse_inference_params(jax.tree.map(jnp.asarray, p), jcfg)
    tf = M.fuse_inference_params(params_to_torch(p), tcfg)
    jp = JB.BatchedPLC(jf, jcfg, jax.tree.map(jnp.asarray, pp), batch=BATCH,
                       use_kernel=True, non_causal=True)
    tp = B.BatchedPLC(tf, tcfg, params_to_torch(pp), batch=BATCH, device="cpu",
                      use_kernel=True, non_causal=True)
    assert JB._FASTTF
    jp.kw = JK.kernel_weights(jf, jcfg, dtype=jnp.float32)
    tp.kw = K.kernel_weights(tf, tcfg, dtype=torch.float32)
    rs = np.random.RandomState(0)
    pcm = (rs.randn(BATCH, N_FRAMES, 160) * 2000).astype(np.float32)
    lost = np.zeros((BATCH, N_FRAMES), bool)
    lost[:4, 3] = True            # a loss, its recovery and resync on half
    lost[:2, 4] = True            # a double loss
    lost[6, 5:7] = True
    rec = dict(pcm=pcm, lost=lost, jout=[], tout=[], jstate=[], tstate=[])
    for k in range(N_FRAMES):
        tp.state = plc_state_to_torch(jp.state)
        rec["jout"].append(jp.step(pcm[:, k], lost[:, k]))
        rec["tout"].append(tp.step(pcm[:, k], lost[:, k]))
        rec["jstate"].append(state_to_numpy(plc_state_to_torch(jp.state)))
        rec["tstate"].append(state_to_numpy(tp.state))
    rec["stats"] = tp.stats
    return rec


def test_full_width_good_streams_pass_through(full_run):
    """Streams that never lose a frame come back 80 samples late, exactly,
    on both sides; 8 streams are below the floor of compaction."""
    good = ~full_run["lost"].any(axis=1)
    assert good.sum() == 3
    flat = full_run["pcm"][good].reshape(good.sum(), -1)
    for k in range(1, N_FRAMES):
        want = flat[:, k * 160 - 80:(k + 1) * 160 - 80]
        assert np.array_equal(full_run["tout"][k][good], want)
        assert np.array_equal(full_run["jout"][k][good], want)
    assert full_run["stats"] == {"compacted": 0, "overflowed": 0, "full": N_FRAMES}


def test_full_width_each_frame_matches_jax(full_run):
    """From the JAX package's state, every frame: integer state and RNG
    words exact; conditioning within 1e-4, features within 2e-4, PLC-net
    state within 5e-4; GRU-A and GRU-B of the sample state within 2e-2 and
    the signal state within 1 on 98 % of entries; audio within 1 LSB on at
    least 98 % of a frame's samples (test_torch_plc_kernel_path.py's bars)."""
    for k in range(N_FRAMES):
        js, ts = full_run["jstate"][k], full_run["tstate"][k]
        for f in ("loss_count", "queued"):
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
        close = np.abs(ts["sstate"]["last_sig"] - js["sstate"]["last_sig"]) <= 1.0
        assert close.mean() >= 0.98, (k, close.mean())
        d = np.abs(full_run["tout"][k] - full_run["jout"][k])
        assert (d <= 1.0).mean() >= 0.98, (k, (d <= 1.0).mean())
    assert max(s["loss_count"].max() for s in full_run["jstate"]) == 2
    assert any(s["queued"].any() for s in full_run["jstate"])
