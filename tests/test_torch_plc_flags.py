"""The options of the port's batched PLC (the chain kernel, the compaction's
capacity), on the kernel program with the kernels' plain versions, and the
serving pool and entry points, on the CPU at a small size."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from lpcnet_tpu.plc import batched as JB

from lpcnet_torch.kernels import plc_chain as PC
from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.plc import batched as B
from lpcnet_torch.runtime.serving import PLCStreamPool
from lpcnet_torch.weights.convert import state_to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TCFG = M.LPCNetConfig(rnn_units1=64, rnn_units2=16, cond_size=32)
INT_FIELDS = ("pcm_fill", "skip_analysis", "loss_count", "fec_len", "fec_read",
              "fec_keep", "fec_skip", "blend", "feat_count")


@pytest.fixture(scope="module")
def models():
    """(port fused, port PLC params) from numpy seeds."""
    return (M.fuse_inference_params(M.init_params(TCFG, seed=0), TCFG),
            PM.init_params(seed=1))


def _speech(batch, frames):
    pcm = np.load(ROOT / "tests" / "fixtures" / "codec.npz")["pcm"].astype(np.float32)
    pcm = np.tile(pcm, frames * 160 // len(pcm) + 2)
    return np.stack([np.roll(pcm, 37 * i)[:frames * 160] for i in range(batch)]
                    ).reshape(batch, frames, 160)


def _flag_run(models, b, frames, seed, enable_blending=True, fec=True,
              chain=False, compact_cap=None, cfg=TCFG, non_causal=False,
              loss=0.2, dense=0.9):
    tf, tpp = models
    rs = np.random.RandomState(seed)
    pcm = (rs.randn(b, frames, 160) * 2000).astype(np.float32)
    lost = rs.rand(b, frames) < loss
    lost[:, 4] = rs.rand(b) < dense         # a dense frame
    lost[0] = False
    rows = (rs.randn(3, 20) * 0.2).astype(np.float32)
    plc = B.BatchedPLC(tf, cfg, tpp, batch=b, device="cpu", use_kernel=True,
                       enable_blending=enable_blending, chain=chain,
                       non_causal=non_causal)
    if compact_cap is not None:
        plc.compact_cap = compact_cap
    if fec:
        for row in rows:
            plc.fec_add(np.tile(row, (b, 1)), have=np.arange(b) % 3 == 0)
    before = (K.synthesize_frame_masked_kernel.launches,
              K.teacher_force_blocks_kernel.launches, PC.plc_chain_kernel.launches)
    out = plc.run(pcm, lost)
    assert before == (K.synthesize_frame_masked_kernel.launches,
                      K.teacher_force_blocks_kernel.launches,
                      PC.plc_chain_kernel.launches)        # CPU: plain versions
    if not non_causal:
        assert np.array_equal(out[0], np.clip(pcm[0], -32768, 32767))
    return out, state_to_numpy(plc.state), plc


def _same_tolerance_class(a, b_):
    out_a, st_a, _ = a
    out_b, st_b, _ = b_
    for f in INT_FIELDS:
        assert np.array_equal(st_a[f], st_b[f]), f
    np.testing.assert_allclose(st_a["features"], st_b["features"], atol=2e-4)
    for g in ("gru1", "gru2"):
        np.testing.assert_allclose(st_a["plc_net"][g], st_b["plc_net"][g], atol=2e-5)
    assert np.array_equal(out_a[0], out_b[0])
    d = np.abs(out_a.astype(np.float64) - out_b)
    assert (d > 2).mean() < 0.02, (d > 2).mean()


def test_default_flags_are_the_jax_defaults(models):
    """The port's one program is the JAX package's default one (its
    `fasttf` and `fastfnet` on): the chain kernel off unless a pool asks
    for it, and compaction at the JAX package's capacity, b/4 rounded up to
    32 and none below 128 streams, taken once when a pool is built. No
    environment variable changes it."""
    tf, tpp = models
    assert JB._FASTTF and JB._FASTFNET
    for b in (64, 128, 129, 256, 1024):
        plc = B.BatchedPLC(tf, TCFG, tpp, batch=b, device="cpu", use_kernel=True)
        assert plc.compact_cap == JB._compact_capacity(b) == B._compact_capacity(b)
        assert plc._cw is None
    assert B._compact_capacity(256) == 64 and B._compact_capacity(64) == 0
    src = (ROOT / "lpcnet_torch" / "plc" / "batched.py").read_text()
    assert src.count("os.environ") == 0 and "getenv" not in src


@pytest.mark.parametrize("enable_blending", [True, False])
def test_chain_on_equals_off(models, enable_blending):
    """The PLC-net chain (K4's plain version) against the masked calls in a
    row: features within 2e-4, PLC-net state within 2e-5, FEC pointers and
    loss counts exact, audio in the same tolerance class (the JAX package's
    bars for its own flag)."""
    on = _flag_run(models, 8, 12, 3, enable_blending=enable_blending, chain=True)
    off = _flag_run(models, 8, 12, 3, enable_blending=enable_blending)
    assert on[2]._cw is not None and off[2]._cw is None
    _same_tolerance_class(on, off)


def _compaction_equal(on, off):
    """Compacted against the full batch: a stream that is never active is
    bit-equal; float leaves of the sample state agree to 1e-5 of their
    scale (a sub-batch's matrix products may block their sums
    differently)."""
    sa, sb = on[1]["sstate"], off[1]["sstate"]
    for f in ("gru_a", "gru_b", "last_sig", "deemph"):
        assert np.array_equal(sa[f][0], sb[f][0]), f
        np.testing.assert_allclose(sa[f], sb[f],
                                   atol=1e-5 * max(1.0, np.abs(sb[f]).max()))
    assert np.array_equal(sa["last_exc"], sb["last_exc"])
    assert all(np.array_equal(sa["rng"][f], sb["rng"][f]) for f in sa["rng"])


@pytest.mark.parametrize("enable_blending", [True, False])
def test_compaction_on_equals_off(models, enable_blending):
    """The sample-rate section on a capacity-8 sub-batch of 16 streams
    against the full batch. Sparse-loss frames compact, the dense one
    overflows and falls through."""
    on = _flag_run(models, 16, 10, 5, enable_blending=enable_blending,
                   compact_cap=8)
    off = _flag_run(models, 16, 10, 5, enable_blending=enable_blending,
                    compact_cap=0)
    assert on[2].stats["compacted"] > 0 and on[2].stats["overflowed"] > 0
    assert on[2].stats["full"] == 0 and off[2].stats == {
        "compacted": 0, "overflowed": 0, "full": 10}
    _same_tolerance_class(on, off)
    _compaction_equal(on, off)


@pytest.mark.parametrize("non_causal", [False, True], ids=["causal", "nc"])
def test_compaction_at_the_rules_capacity(models, non_causal):
    """128 streams take the rule's own capacity, 32: every frame's section
    runs on the sub-batch (10 % of the streams lost, a dense frame of 15 %),
    against the same frames with `compact_cap = 0`. Integer state and RNG
    words equal, features within 2e-4, audio within the tolerance class;
    the non-causal mode (a lookahead-0 model, 80 samples late) the same."""
    cfg = dataclasses.replace(TCFG, lookahead=0) if non_causal else TCFG
    run = dict(enable_blending=True, fec=not non_causal, cfg=cfg,
               non_causal=non_causal, loss=0.1, dense=0.15)
    on = _flag_run(models, 128, 6, 9, **run)
    off = _flag_run(models, 128, 6, 9, compact_cap=0, **run)
    assert on[2].compact_cap == 32
    assert on[2].stats == {"compacted": 6, "overflowed": 0, "full": 0}
    assert off[2].stats == {"compacted": 0, "overflowed": 0, "full": 6}
    fields = ("loss_count", "queued") if non_causal else INT_FIELDS
    for f in fields:
        assert np.array_equal(on[1][f], off[1][f]), f
    np.testing.assert_allclose(on[1]["features"], off[1]["features"], atol=2e-4)
    assert np.array_equal(on[0][0], off[0][0])
    d = np.abs(on[0].astype(np.float64) - off[0])
    assert (d > 2).mean() < 0.02, (d > 2).mean()
    _compaction_equal(on, off)


def test_kernel_tap_sees_every_call_and_changes_nothing(models, monkeypatch):
    """`kernel_tap` is handed each kernel call of a frame with its
    arguments (the section: K3 once, K2 twice, K4 once with the chain on),
    and the run's output is bit-equal with and without it."""
    frames = 6
    per_frame = {"teacher_force_blocks_kernel": 1,
                 "synthesize_frame_masked_kernel": 2, "plc_chain_kernel": 1}
    want = _flag_run(models, 6, frames, 7, chain=True)[0]
    seen = {}
    monkeypatch.setattr(B, "kernel_tap",
                        lambda name, args: seen.setdefault(name, []).append(args))
    got = _flag_run(models, 6, frames, 7, chain=True)[0]
    assert np.array_equal(got, want)
    assert {k: len(v) for k, v in seen.items()} == {
        k: n * frames for k, n in per_frame.items()}
    b_of = {k: v[0][1].gru_a.shape[0] if k != "plc_chain_kernel" else v[0][1].shape[0]
            for k, v in seen.items()}
    assert set(b_of.values()) == {6}


# --------------------------------------------------------------------------
# The serving pool and the entry points
# --------------------------------------------------------------------------

def test_pool_attach_reset_detach_leave_other_slots_alone(models):
    tf, tpp = models
    pool = PLCStreamPool(tf, TCFG, tpp, capacity=4, device="cpu")
    solo = PLCStreamPool(tf, TCFG, tpp, capacity=4, device="cpu")
    pcm = _speech(3, 10)
    for k in range(6):
        out = pool.step({"a": pcm[0, k], "b": None if k in (3, 4) else pcm[1, k]})
        assert set(out) == {"a", "b"} and out["a"].shape == (160,)
        assert np.array_equal(out["a"], pcm[0, k])
    assert pool.n_active == 2 and pool.slot_of == {"a": 0, "b": 1}
    before = state_to_numpy(pool.plc.state)
    pool.detach("a")
    assert pool.attach("c") == 0 and pool.attach("c") == 0
    after = state_to_numpy(pool.plc.state)
    fresh = state_to_numpy(pool.plc.init_state())

    def leaves(d, path=()):
        for k, v in d.items():
            yield from leaves(v, path + (k,)) if isinstance(v, dict) else [(path + (k,), v)]

    for (path, new), (_, old), (_, ini) in zip(leaves(after), leaves(before), leaves(fresh)):
        ax = 1 if path[0] == "plc_ring" else 0
        assert np.array_equal(np.take(new, 0, axis=ax), np.take(ini, 0, axis=ax)), path
        assert np.array_equal(np.delete(new, 0, axis=ax), np.delete(old, 0, axis=ax)), path
    assert before["sstate"]["gru_a"][1].any()
    # the new stream in the reset slot behaves as a stream in a fresh pool
    for k in range(6, 10):
        lost = k == 8
        a = pool.step({"c": None if lost else pcm[2, k], "b": pcm[1, k]})
        s = solo.step({"c": None if lost else pcm[2, k]})
        assert np.array_equal(a["c"], s["c"])
    pool.fec_add({"b": np.zeros(36, np.float32), "c": None})
    st = state_to_numpy(pool.plc.state)
    assert st["fec_len"].tolist() == [0, 1, 0, 0] and st["fec_skip"].tolist() == [1, 0, 0, 0]
    for sid in ("x", "y"):
        pool.attach(sid)
    with pytest.raises(RuntimeError, match="full"):
        pool.attach("z")


def test_entry_points_default_to_cuda_and_later_modes_raise(models, monkeypatch):
    tf, tpp = models
    with pytest.raises(ValueError, match="lookahead-0"):
        B.BatchedPLC(tf, TCFG, tpp, 2, non_causal=True, device="cpu")
    with pytest.raises(ValueError, match="fused step only"):
        B.BatchedPLC(tf, TCFG, tpp, 2, fused_step=False, remove_dc=True,
                     device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        B.BatchedPLC(tf, TCFG, tpp, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        PLCStreamPool(tf, TCFG, tpp, capacity=2)
    plc = B.BatchedPLC(tf, TCFG, tpp, 2, device="cpu")
    assert plc.device.type == "cpu" and plc.plc_buf_size == 400
    plc.fec_add(np.ones((2, 20), np.float32))
    plc.fec_clear()
    assert not plc.state.fec_len.any()
    plc.step(np.zeros((2, 160)), np.zeros(2))
    plc.reset()
    assert int(plc.state.fstate.frame_count.max()) == 0
