"""The decoder's frame network on the CPU: `M.FrameNetworkGraph` is the plain
`frame_network` there (no capture, no counter moves), the body its CUDA
graph captures gives `frame_network`'s values with the new state written in
place, a `frame_state` assigned from outside reaches the next frame, and the
constants the frame network reads on a card (the DSP matrices, the LPC
weighting factors, the C tansig table) are made once a device with the
values they had when they were uploaded every call. The graph's replays
are tested on the card (`tests/test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch

from lpcnet_torch.codec.decoder import LPCNetDecoder
from lpcnet_torch.dsp import lpc as L
from lpcnet_torch.dsp import spectrum as S
from lpcnet_torch.dsp.constants import BAND_INTERP, LPC_ORDER
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.nn import layers as NL
from lpcnet_torch.runtime.serving import StreamPool

torch.set_num_threads(1)

SMALL = dict(rnn_units1=64, rnn_units2=16, cond_size=32, pitch_embed_dim=8)
CFGS = {"default": {}, "lookahead1": {"lookahead": 1},
        "lookahead0": {"lookahead": 0}, "gamma": {"lpc_gamma": 0.92},
        "e2e": {"e2e": True}}


@pytest.fixture(autouse=True)
def recomputed_tansig_table(monkeypatch):
    """The recomputed C tansig table and the exact activations: a C-gate
    module run earlier in the same process may have installed the
    reference's own table. monkeypatch restores both afterwards."""
    monkeypatch.setattr(NL, "_TANSIG_TABLE", None)
    monkeypatch.setattr(NL, "_ACT_IMPL", "exact")


def _model(seed=1, **over):
    cfg = M.LPCNetConfig(**SMALL, **over)
    return M.fuse_inference_params(M.init_params(cfg, seed=seed), cfg), cfg


def _features(b, frames, seed):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy((rs.normal(size=(b, 36)) * 0.3).astype(np.float32))
            for _ in range(frames)]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", list(CFGS))
def test_graph_call_on_cpu_is_frame_network(name):
    """On CPU tensors a `FrameNetworkGraph` call is `frame_network`: the
    same five outputs bit for bit over a run of frames, new tensors each
    frame (the state passed in untouched), and no counter moves."""
    fused, cfg = _model(**CFGS[name])
    g = M.FrameNetworkGraph()
    fs = gs = M.init_frame_state(3, cfg)
    for f in _features(3, 5, seed=2):
        before = [t.clone() for t in gs]
        want = M.frame_network(fused, fs, f, cfg)
        got = g(fused, gs, f, cfg)
        assert _equal(got[0], want[0]) and _equal(got[1:], want[1:])
        assert _equal(gs, before)
        fs, gs = want[0], got[0]
    assert (g.captures, g.replays, g.eager) == (0, 0, 0)


@pytest.mark.parametrize("name", list(CFGS))
def test_graph_body_writes_the_state_in_place(name):
    """The body the CUDA graph captures: `frame_network` with its new state
    copied into the state buffers it read, and cond, cond_a, cond_b and lpc
    as `frame_network` gives them; lpc no view of the buffers (with a
    lookahead it is the FIFO's last row, which the copy overwrites)."""
    fused, cfg = _model(**CFGS[name])
    fs = M.init_frame_state(4, cfg)
    bufs = M.FrameState(*(t.clone() for t in fs))
    ptrs = [t.data_ptr() for t in bufs]
    for f in _features(4, 4, seed=3):
        want = M.frame_network(fused, fs, f, cfg)
        got = M.FrameNetworkGraph._body(fused, bufs, f, cfg)
        assert _equal(bufs, want[0]) and _equal(got, want[1:])
        assert [t.data_ptr() for t in bufs] == ptrs
        lpc_ptr = got[3].untyped_storage().data_ptr()
        assert all(lpc_ptr != t.untyped_storage().data_ptr() for t in bufs)
        fs = want[0]


def _decoder_frames(dec, feats):
    return [dec.synthesize(f.numpy()) for f in feats]


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_cpu_decoder_runs_the_plain_frame_network(use_kernel):
    """A CPU decoder's frames: `frame_state` after each is
    `frame_network`'s, bit for bit, the counters stay at zero, and a
    reference to `frame_state` taken before a frame keeps its values."""
    fused, cfg = _model()
    dec = LPCNetDecoder.from_fused(fused, cfg, 3, device="cpu",
                                   use_kernel=use_kernel)
    fs = dec.frame_state
    for f in _features(3, 4, seed=4):
        held = dec.frame_state
        kept = [t.clone() for t in held]
        dec.synthesize(f.numpy())
        fs = M.frame_network(fused, fs, f, cfg)[0]
        assert _equal(dec.frame_state, fs)
        assert _equal(held, kept)
    g = dec.frame_graph
    assert (g.captures, g.replays, g.eager) == (0, 0, 0)


@pytest.mark.parametrize("how", ["restore", "reset_slot"])
def test_assigned_frame_state_reaches_the_next_frame(how):
    """`frame_state` assigned from outside, as a restored snapshot (whole
    clones) or `StreamPool._reset_slot` (one slot of a clone) assigns it,
    is the state the next frame starts from, and the assigned tensors keep
    their values."""
    fused, cfg = _model()
    feats = _features(3, 6, seed=5)
    pool = StreamPool(fused, cfg, capacity=3, device="cpu")
    dec = pool.dec
    _decoder_frames(dec, feats[:2])
    snap = [t.clone() for t in dec.frame_state]
    _decoder_frames(dec, feats[2:4])
    if how == "restore":
        dec.frame_state = M.FrameState(*(t.clone() for t in snap))
    else:
        pool._reset_slot(1)
        assert not dec.frame_state.frame_count[1]
    fs = dec.frame_state
    given = [t.clone() for t in fs]
    _decoder_frames(dec, feats[4:])
    want = M.FrameState(*given)
    for f in feats[4:]:
        want = M.frame_network(fused, want, f, cfg)[0]
    assert _equal(dec.frame_state, want)
    assert _equal(fs, given)


@pytest.mark.parametrize("gamma", [0.92, 0.85, 1.05])
def test_lpc_weighting_values_unchanged(gamma):
    """`lpc_weighting` with its factors kept a (gamma, device) gives what it
    gave when it built them every call, call after call."""
    lpc = torch.from_numpy(np.random.RandomState(6).normal(
        size=(5, LPC_ORDER)).astype(np.float32))
    k = torch.arange(1, LPC_ORDER + 1, dtype=torch.float32)
    want = lpc * torch.pow(torch.tensor(gamma, dtype=torch.float32), k)
    assert torch.equal(L.lpc_weighting(lpc, gamma), want)
    kept = L._WEIGHTS[(float(gamma), lpc.device)]
    assert torch.equal(L.lpc_weighting(lpc, gamma), want)
    assert L._WEIGHTS[(float(gamma), lpc.device)] is kept


def test_tansig_table_values_unchanged_and_kept_a_device():
    """The cref tanh reads the same table as before (values equal the
    recomputed C table's lookup), the copy on another device is made once
    a host table and follows a new one (`set_cref_tansig_table`), and
    `activation_key` names the implementation and that copy."""
    x = torch.linspace(-9.0, 9.0, 4001)
    t = np.round(np.tanh(0.04 * np.arange(201, dtype=np.float64)), 6)
    table = torch.from_numpy(t.astype(np.float32))
    ax = x.abs()
    i = torch.clamp(torch.floor(0.5 + 25.0 * ax), max=200.0)
    ax = ax - 0.04 * i
    y = table[i.long()]
    y = y + ax * (1.0 - y * y) * (1.0 - y * ax)
    assert torch.equal(NL.tanh_cref(x), torch.where(x < 0, -y, y))
    meta = NL._tansig_table("meta")
    assert meta.device.type == "meta" and NL._tansig_table("meta") is meta
    assert NL.activation_key("meta") == ("exact", None)
    with NL.activation_impl("cref"):
        impl, on_meta = NL.activation_key("meta")
        assert impl == "cref" and on_meta is meta
        NL.set_cref_tansig_table(t.astype(np.float32))
        assert NL.activation_key("meta")[1] is not meta
        assert torch.equal(NL._tansig_table("cpu"), table)


def test_dsp_constants_are_made_once_a_device():
    """`spectrum._const` keeps one tensor a (constant, device), equal to
    the upload it replaces."""
    like = torch.zeros(1)
    a = S._const(BAND_INTERP, like)
    assert S._const(BAND_INTERP, like) is a
    assert torch.equal(a, torch.as_tensor(BAND_INTERP, dtype=torch.float32))
    m = S._const(BAND_INTERP, torch.zeros(1, device="meta"))
    assert m.device.type == "meta" and m is not a
