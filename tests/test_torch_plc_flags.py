"""The flags of the port's batched PLC (which of the ported paths a frame
takes), on the kernel program with the kernels' plain versions, and the
serving pool and entry points, on the CPU at a small size."""

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


def _flag_run(models, b, frames, seed, enable_blending=True, fec=True, **flags):
    tf, tpp = models
    rs = np.random.RandomState(seed)
    pcm = (rs.randn(b, frames, 160) * 2000).astype(np.float32)
    lost = rs.rand(b, frames) < 0.2
    lost[:, 4] = rs.rand(b) < 0.9           # a dense frame
    lost[0] = False
    rows = (rs.randn(3, 20) * 0.2).astype(np.float32)
    prev = B.set_plc_flags(**flags)
    try:
        plc = B.BatchedPLC(tf, TCFG, tpp, batch=b, device="cpu",
                           use_kernel=True, enable_blending=enable_blending)
    finally:
        B.set_plc_flags(*prev)
    if fec:
        for row in rows:
            plc.fec_add(np.tile(row, (b, 1)), have=np.arange(b) % 3 == 0)
    before = (K.synthesize_frame_masked_kernel.launches,
              K.teacher_force_blocks_kernel.launches, PC.plc_chain_kernel.launches)
    out = plc.run(pcm, lost)
    assert before == (K.synthesize_frame_masked_kernel.launches,
                      K.teacher_force_blocks_kernel.launches,
                      PC.plc_chain_kernel.launches)        # CPU: plain versions
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


def test_default_flags_are_the_jax_defaults(monkeypatch):
    """Fast TF on, fast frame net on, chain kernel off, compaction auto with
    capacity b/4 rounded up to 32 and none below 128 streams; the module
    reads only the four environment variables the JAX package reads."""
    for v in ("LPCNET_PLC_FASTTF", "LPCNET_PLC_FASTFNET", "LPCNET_PLC_FASTCHAIN",
              "LPCNET_PLC_COMPACT"):
        monkeypatch.delenv(v, raising=False)
    import importlib
    fresh = importlib.reload(B)
    try:
        assert fresh.current_flags() == (True, True, False, "auto")
        assert fresh.current_flags() == (JB._FASTTF, JB._FASTFNET, JB._FASTCHAIN,
                                         JB._COMPACT_ENV)
        for b in (256, 1024, 129, 128, 64):
            assert fresh._compact_capacity(b) == JB._compact_capacity(b)
        assert fresh._compact_capacity(256) == 64 and fresh._compact_capacity(64) == 0
        src = (ROOT / "lpcnet_torch" / "plc" / "batched.py").read_text()
        assert src.count("os.environ") == 4
        prev = fresh.set_plc_flags(fastchain=True, compact=8)
        assert fresh.current_flags() == (True, True, True, "8")
        assert fresh._compact_capacity(256) == 8
        assert fresh.set_plc_flags(*prev) == (True, True, True, "8")
        assert fresh.current_flags() == (True, True, False, "auto")
    finally:
        importlib.reload(B)


def test_fast_frame_net_on_equals_off(models):
    """The deferred frame nets as one flush or as four masked steps."""
    _same_tolerance_class(_flag_run(models, 6, 10, 2, fastfnet=True),
                          _flag_run(models, 6, 10, 2, fastfnet=False))


@pytest.mark.parametrize("enable_blending", [True, False])
def test_chain_on_equals_off(models, enable_blending):
    """The PLC-net chain (K4's plain version) against the masked calls in a
    row: features within 2e-4, PLC-net state within 2e-5, FEC pointers and
    loss counts exact, audio in the same tolerance class (the JAX package's
    bars for its own flag)."""
    on = _flag_run(models, 8, 12, 3, enable_blending=enable_blending, fastchain=True)
    off = _flag_run(models, 8, 12, 3, enable_blending=enable_blending, fastchain=False)
    assert on[2].flags.fastchain and on[2]._cw is not None and off[2]._cw is None
    _same_tolerance_class(on, off)


@pytest.mark.parametrize("enable_blending", [True, False])
def test_compaction_on_equals_off(models, enable_blending):
    """The sample-rate section on a capacity-8 sub-batch of 16 streams
    against the full batch. Sparse-loss frames compact, the dense one
    overflows and falls through. A stream that is never active is bit-equal;
    float leaves of the sample state agree to 1e-5 of their scale (a
    sub-batch's matrix products may block their sums differently)."""
    on = _flag_run(models, 16, 10, 5, enable_blending=enable_blending, compact="8")
    off = _flag_run(models, 16, 10, 5, enable_blending=enable_blending, compact="0")
    assert on[2].stats["compacted"] > 0 and on[2].stats["overflowed"] > 0
    assert on[2].stats["full"] == 0 and off[2].stats == {
        "compacted": 0, "overflowed": 0, "full": 10}
    _same_tolerance_class(on, off)
    sa, sb = on[1]["sstate"], off[1]["sstate"]
    for f in ("gru_a", "gru_b", "last_sig", "deemph"):
        assert np.array_equal(sa[f][0], sb[f][0]), f
        np.testing.assert_allclose(sa[f], sb[f],
                                   atol=1e-5 * max(1.0, np.abs(sb[f]).max()))
    assert np.array_equal(sa["last_exc"], sb["last_exc"])
    assert all(np.array_equal(sa["rng"][f], sb["rng"][f]) for f in sa["rng"])


def test_slow_tf_path_matches_the_section(models):
    """`fasttf` off runs the interleaved program, its drain through K2 with
    the sampler off: integer state equal, audio in the same class."""
    _same_tolerance_class(_flag_run(models, 6, 10, 6, fasttf=True),
                          _flag_run(models, 6, 10, 6, fasttf=False))


@pytest.mark.parametrize("flags, per_frame", [
    (dict(fastchain=True), {"teacher_force_blocks_kernel": 1,
                            "synthesize_frame_masked_kernel": 2,
                            "plc_chain_kernel": 1}),
    (dict(fasttf=False), {"synthesize_frame_masked_kernel": 5}),
])
def test_kernel_tap_sees_every_call_and_changes_nothing(models, monkeypatch,
                                                        flags, per_frame):
    """`kernel_tap` is handed each kernel call of a frame with its
    arguments (the section: K3 once, K2 twice, K4 once with the chain on;
    without `fasttf`: three drain prefixes, the head and the tail through
    K2), and the run's output is bit-equal with and without it."""
    frames = 6
    want = _flag_run(models, 6, frames, 7, **flags)[0]
    seen = {}
    monkeypatch.setattr(B, "kernel_tap",
                        lambda name, args: seen.setdefault(name, []).append(args))
    got = _flag_run(models, 6, frames, 7, **flags)[0]
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
