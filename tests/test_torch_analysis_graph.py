"""DRED's two-frame analysis on the CPU: `features.AnalysisGraph` is the two
plain `compute_single_frame_features` calls there (no capture, no counter
moves), the body its CUDA graph captures gives their values with the new
state written in place, and an analysis state assigned to
`DREDEncoderPool.features` from outside (a restored snapshot, a fresh
state) is the state the next tick starts from. The graph's replays are
tested on the card (`tests/test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch

from lpcnet_torch.codec import features as F
from lpcnet_torch.models import rdovae as RV
from lpcnet_torch.runtime.serving import DREDEncoderPool

torch.set_num_threads(1)

B = 3
N_LEAVES = 11     # 8 tensors of EncoderState and the ViterbiCarry's 3


def _speech(b, ticks, seed):
    """[ticks, b, 320] float32: a harmonic voice a stream with noise."""
    rs = np.random.RandomState(seed)
    t = np.arange(ticks * 320) / 16000.0
    f0 = rs.uniform(90, 220, (b, 1))
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rs.uniform(2, 5, (b, 1)) * t)
    pcm = np.round(4000 * env * sig + 60 * rs.randn(b, len(t)))
    return torch.from_numpy(pcm.astype(np.float32).reshape(b, ticks, 320)
                            ).transpose(0, 1).contiguous()


def _plain(state, pcm):
    state, f0 = F.compute_single_frame_features(state, pcm[:, :160])
    state, f1 = F.compute_single_frame_features(state, pcm[:, 160:])
    return state, f0, f1


def _equal(a, b):
    la, lb = F._leaves(a), F._leaves(b)
    return len(la) == len(lb) == N_LEAVES and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_graph_call_on_cpu_is_two_plain_calls(seed):
    """On CPU tensors an `AnalysisGraph` call is the two plain calls: both
    feature rows and every state leaf (the ViterbiCarry's included) bit
    for bit over a run of ticks of speech, new tensors each tick (the
    state passed in untouched), and no counter moves."""
    g = F.AnalysisGraph()
    ps = gs = F.init_encoder_state(B)
    for pcm in _speech(B, 8, seed):
        before = F._clone_state(gs)
        ws, w0, w1 = _plain(ps, pcm)
        st, f0, f1 = g(gs, pcm)
        assert _equal(st, ws) and torch.equal(f0, w0) and torch.equal(f1, w1)
        assert _equal(gs, before)
        ps, gs = ws, st
    assert int(gs.viterbi.best_i.abs().sum()) > 0     # the tracker moved
    assert not g.stats


@pytest.mark.parametrize("seed", [4, 5])
def test_graph_body_writes_the_state_in_place(seed):
    """The body the CUDA graph captures: the two plain calls with their new
    state copied into the state buffers they read, every leaf keeping its
    storage, and f0, f1 as the plain calls give them, in no buffer."""
    ps = F.init_encoder_state(B)
    bufs = F._clone_state(ps)
    ptrs = [t.data_ptr() for t in F._leaves(bufs)]
    for pcm in _speech(B, 6, seed):
        ps, w0, w1 = _plain(ps, pcm)
        f0, f1 = F.AnalysisGraph._body(bufs, pcm)
        assert _equal(bufs, ps)
        assert torch.equal(f0, w0) and torch.equal(f1, w1)
        assert [t.data_ptr() for t in F._leaves(bufs)] == ptrs
        for f in (f0, f1):
            assert all(f.untyped_storage().data_ptr()
                       != t.untyped_storage().data_ptr()
                       for t in F._leaves(bufs))


@pytest.fixture(scope="module")
def pool_params():
    cfg = RV.RDOVAEConfig()
    return RV.init_params(cfg, seed=2), cfg


@pytest.mark.parametrize("how", ["restore", "fresh"])
def test_assigned_analysis_state_reaches_the_next_tick(how, pool_params):
    """`DREDEncoderPool.features` assigned from outside, as the benchmark's
    `restore()` assigns a snapshot's clone or a caller a fresh
    `init_encoder_state`, is the state the next tick's analysis starts
    from; the assigned tensors keep their values, and a CPU pool counts no
    analysis graph."""
    params, cfg = pool_params
    pool = DREDEncoderPool(params, cfg, streams=B, num_redundancy_frames=4,
                           device="cpu")
    audio = _speech(B, 7, seed=6)
    for pcm in audio[:2]:
        pool.step_pcm(pcm)
    snap = F._clone_state(pool.features)
    for pcm in audio[2:4]:
        pool.step_pcm(pcm)
    pool.features = (F._clone_state(snap) if how == "restore"
                     else F.init_encoder_state(B))
    given = pool.features
    kept = F._clone_state(given)
    want = kept
    for pcm in audio[4:]:
        pool.step_pcm(pcm)
        want = _plain(want, pcm)[0]
    assert _equal(pool.features, want)
    assert _equal(given, kept)
    assert not any(k.startswith("analysis_") for k in pool.stats)
