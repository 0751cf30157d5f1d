"""The port's batched non-causal PLC step held to the port's own oracles, on
the CPU at a small size (Na=64, Nb=16, cond 32), on the step-by-step float32
model: the port's host PLC (`plc.plc.PLC`), per-stream independence, the
fused step against the two-path step in both modes; and the non-causal
serving pool. The JAX package's gates are those of test_plc_batched.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.plc import batched as B
from lpcnet_torch.plc import plc as P
from lpcnet_torch.runtime.serving import PLCStreamPool
from lpcnet_torch.weights.convert import state_to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(rnn_units1=64, rnn_units2=16, cond_size=32)
N_FRAMES = 14


def _speech(batch, frames, dc=0.0):
    pcm = np.load(ROOT / "tests" / "fixtures" / "codec.npz")["pcm"].astype(np.float32)
    pcm = np.tile(pcm, frames * 160 // len(pcm) + 2)
    return np.stack([np.roll(pcm, 37 * i)[:frames * 160] for i in range(batch)]
                    ).reshape(batch, frames, 160) + dc


@pytest.fixture(scope="module")
def weights():
    """numpy-seeded weights (vocoder params, PLC params)."""
    return M.init_params(M.LPCNetConfig(**SMALL), seed=0), PM.init_params(seed=1)


def _port(weights, lookahead=0):
    p, pp = weights
    cfg = M.LPCNetConfig(**SMALL, lookahead=lookahead)
    return M.fuse_inference_params(p, cfg), pp, cfg


@pytest.mark.parametrize("remove_dc", [False, True], ids=["nc", "nc_dc"])
def test_batched_matches_host_non_causal(weights, remove_dc):
    """test_plc_batched.py:76 and :233 on the port: every stream on one
    pattern, the batched step against the port's host PLC (whose crossfade
    and DC loops run in float64): within 1 LSB and under 2 % of a frame's
    samples off (with the DC filter 2 and 5 %); and a clean run locks the
    DC tracker onto the input's offset."""
    tf, tpp, cfg = _port(weights)
    options = P.LPCNET_PLC_NONCAUSAL | (P.LPCNET_PLC_DC_FILTER if remove_dc else 0)
    host = P.PLC(tf, cfg, tpp, options=options, batch=2, device="cpu")
    batched = B.BatchedPLC(tf, cfg, tpp, batch=2, non_causal=True,
                           remove_dc=remove_dc, device="cpu")
    pcm = _speech(2, N_FRAMES, dc=300.0 if remove_dc else 0.0)
    lost = [0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0, 0] if remove_dc else \
        [0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0]
    max_d, max_frac = (2.0, 0.05) if remove_dc else (1.0, 0.02)
    for k in range(N_FRAMES):
        ref = host.conceal() if lost[k] else host.update(pcm[:, k])
        out = batched.step(pcm[:, k], np.full(2, lost[k]))
        d = np.abs(out - ref)
        assert d.max() <= max_d, (k, d.max())
        assert (d > 1e-3).mean() < max_frac, (k, (d > 1e-3).mean())
    if remove_dc:
        clean = B.BatchedPLC(tf, cfg, tpp, batch=2, non_causal=True,
                             remove_dc=True, device="cpu")
        for k in range(8):
            clean.step(pcm[:, k], np.zeros(2))
        assert abs(float(clean.state.dc_mem[0]) - 300.0) < 100.0


def test_dc_mixed_patterns_independent_non_causal(weights):
    """test_plc_batched.py:266: stream i of a mixed-pattern batch equals
    stream i of a batch that runs pattern i everywhere (each stream's RNG
    is seeded by its index, so the same index is compared), non-causal with
    the DC filter, within 1e-3."""
    tf, tpp, cfg = _port(weights)
    patterns = np.array([
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 0, 0],
        [0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0],
    ], bool)
    make = lambda: B.BatchedPLC(tf, cfg, tpp, batch=3, non_causal=True,
                                remove_dc=True, device="cpu")
    pcm = _speech(3, 12, dc=300.0)
    mixed = make().run(pcm, patterns)
    for i in range(3):
        uni = make().run(np.repeat(pcm[i:i + 1], 3, axis=0),
                         np.repeat(patterns[i:i + 1], 3, axis=0))
        np.testing.assert_allclose(mixed[i], uni[i], atol=1e-3, err_msg=f"stream {i}")


@pytest.mark.parametrize("non_causal", [False, True], ids=["causal", "nc"])
def test_fused_step_matches_two_path(weights, non_causal):
    """test_plc_batched.py:305: the single-state interleaved step against
    the evaluate-both-and-merge step, the same sub-operations in the same
    per-stream order: within 1 LSB, under 1 % of a frame's samples off."""
    tf, tpp, cfg = _port(weights, 0 if non_causal else 2)
    a = B.BatchedPLC(tf, cfg, tpp, batch=2, non_causal=non_causal, device="cpu")
    b = B.BatchedPLC(tf, cfg, tpp, batch=2, non_causal=non_causal,
                     fused_step=False, device="cpu")
    pcm = _speech(2, 10)
    lost_per_frame = np.repeat(np.random.RandomState(3).rand(6) < 0.4, 2)
    assert lost_per_frame.any()
    for k in range(10):
        lost = np.array([lost_per_frame[k], lost_per_frame[k + 1]])
        d = np.abs(a.step(pcm[:, k], lost) - b.step(pcm[:, k], lost))
        assert d.max() <= 1.0, (k, d.max())
        assert (d > 1e-3).mean() < 0.01, k


def test_non_causal_pool(weights):
    """`PLCStreamPool(non_causal=True)`: a never-lost stream comes back 80
    samples late; attach, reset and detach leave the other slots alone; a
    stream in a reset slot behaves as one in a fresh pool; no FEC queue."""
    tf, tpp, cfg = _port(weights)
    pool = PLCStreamPool(tf, cfg, tpp, capacity=4, non_causal=True, device="cpu")
    solo = PLCStreamPool(tf, cfg, tpp, capacity=4, non_causal=True, device="cpu")
    pcm = _speech(3, 10)
    for k in range(6):
        out = pool.step({"a": pcm[0, k], "b": None if k in (3, 4) else pcm[1, k]})
        if k:
            assert np.array_equal(out["a"], np.concatenate([pcm[0, k - 1, 80:],
                                                            pcm[0, k, :80]]))
    before = state_to_numpy(pool.plc.state)
    assert before["queued"][1] and before["sstate"]["gru_a"][1].any()
    pool.detach("a")
    assert pool.attach("c") == 0
    after = state_to_numpy(pool.plc.state)
    fresh = state_to_numpy(pool.plc.init_state())

    def leaves(d, path=()):
        for k, v in d.items():
            yield from leaves(v, path + (k,)) if isinstance(v, dict) else [(path + (k,), v)]

    for (path, new), (_, old), (_, ini) in zip(leaves(after), leaves(before), leaves(fresh)):
        ax = 1 if path[0] == "plc_ring" else 0
        assert np.array_equal(np.take(new, 0, axis=ax), np.take(ini, 0, axis=ax)), path
        assert np.array_equal(np.delete(new, 0, axis=ax), np.delete(old, 0, axis=ax)), path
    for k in range(6, 10):
        lost = k == 8
        a = pool.step({"c": None if lost else pcm[2, k], "b": pcm[1, k]})
        s = solo.step({"c": None if lost else pcm[2, k]})
        assert np.array_equal(a["c"], s["c"])
    with pytest.raises(ValueError, match="FEC"):
        pool.fec_add({"b": np.zeros(20, np.float32)})
    with pytest.raises(ValueError, match="lookahead"):
        PLCStreamPool(tf, M.LPCNetConfig(**SMALL), tpp, capacity=2,
                      non_causal=True, device="cpu")
