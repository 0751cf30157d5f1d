"""Streaming feature extraction: the per-frame path
(lpcnet_compute_single_frame_features, src/lpcnet_enc.c:498-600, 814-870),
which packet-loss concealment runs on every frame, and the 40 ms superframe
path of the encoder (process_superframe, lpcnet_compute_features,
:602-700, 895-909).

All state lives in an `EncoderState` of tensors with a leading stream axis.
The excitation filter chain is an FIR over the frame plus a 16-sample
history, written as one windowed product; the pitch correlation is one
[256, 80] product per half-frame (`dsp.pitch`). `superframe_analysis` does
a superframe's four frames in batched operations, with the same state
evolution as four `frame_features_step` calls.

`AnalysisGraph` is DRED's two-frame analysis at one batch every 20 ms tick
(`runtime.serving.DREDEncoderPool`): on CUDA one CUDA graph replay a tick,
captured at the first, in place of ~2,200 small operator calls from the
host.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional, Tuple

import torch

from ..dsp import pitch as pitch_mod
from ..dsp import spectrum
from ..dsp.constants import (FRAME_SIZE, LPC_ORDER, NB_BANDS,
                             NB_TOTAL_FEATURES, OVERLAP_SIZE,
                             PITCH_MAX_PERIOD, PREEMPHASIS, TRAINING_OFFSET)
from ..dsp.lpc import lpc_from_cepstrum

EXC_BUF_SIZE = PITCH_MAX_PERIOD + FRAME_SIZE  # 416 live samples


class EncoderState(NamedTuple):
    """Batched analysis state (cf. LPCNetEncState,
    src/lpcnet_private.h:55-75). Field order as in the JAX package."""
    analysis_mem: torch.Tensor    # [B, 160] previous pre-emphasised frame
    mem_preemph: torch.Tensor     # [B]
    pitch_mem: torch.Tensor       # [B, 16] recent aligned samples, newest first
    pitch_filt: torch.Tensor      # [B]
    exc_buf: torch.Tensor         # [B, 416]
    xc: torch.Tensor              # [B, 10, 256] correlation ring (0, 1 = prev)
    frame_weight: torch.Tensor    # [B, 10]
    viterbi: pitch_mod.ViterbiCarry
    vq_mem: torch.Tensor          # [B, 18]


def init_encoder_state(batch: int, device="cpu") -> EncoderState:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return EncoderState(
        analysis_mem=z(batch, OVERLAP_SIZE), mem_preemph=z(batch),
        pitch_mem=z(batch, LPC_ORDER), pitch_filt=z(batch),
        exc_buf=z(batch, EXC_BUF_SIZE), xc=z(batch, 10, PITCH_MAX_PERIOD),
        frame_weight=z(batch, 10),
        viterbi=pitch_mod.ViterbiCarry.zeros(batch, device),
        vq_mem=z(batch, NB_BANDS))


def preemphasis(x: torch.Tensor, mem: torch.Tensor):
    """y[i] = x[i] - coef*x[i-1] with carried memory (src/lpcnet_enc.c:872-880).
    x [B, N], mem [B] (the C's *mem). Returns (y, new_mem)."""
    y = torch.cat([(x[..., 0] + mem)[..., None],
                   x[..., 1:] - PREEMPHASIS * x[..., :-1]], dim=-1)
    return y, -PREEMPHASIS * x[..., -1]


def _excitation(aligned, lpc, pitch_mem, pitch_filt):
    """LPC residual + 0.7 comb filter (src/lpcnet_enc.c:527-537).

    aligned [B, 160]; lpc [B, 16]; pitch_mem [B, 16] newest first.
    Returns (exc [B, 160], new_pitch_mem, new_pitch_filt)."""
    a_ext = torch.cat([torch.flip(pitch_mem, (-1,)), aligned], dim=-1)
    wins = a_ext.unfold(-1, LPC_ORDER + 1, 1)              # [B, 160, 17]
    coeffs = torch.cat([torch.flip(lpc, (-1,)),
                        torch.ones_like(lpc[..., :1])], dim=-1)
    s = torch.matmul(wins, coeffs[..., None])[..., 0]
    s_prev = torch.cat([pitch_filt[..., None], s[..., :-1]], dim=-1)
    exc = s + 0.7 * s_prev
    return exc, torch.flip(aligned[..., -LPC_ORDER:], (-1,)), s[..., -1]


def frame_features_step(state: EncoderState, frame: torch.Tensor, pcount: int
                        ) -> Tuple[EncoderState, torch.Tensor]:
    """One raw (not pre-emphasised) 10 ms frame [B, 160]; pcount the
    subframe index within the superframe (0..3). Returns (new_state,
    features [B, 36]) with the unquantised LPC in [20:36] and zeros in
    [18:20] (the pitch step fills them)."""
    x, new_preemph = preemphasis(frame.to(torch.float32), state.mem_preemph)
    # last 80 samples of the previous frame + first 80 of this one, read
    # before analysis_mem moves on (src/lpcnet_enc.c:510)
    aligned = torch.cat([state.analysis_mem[..., OVERLAP_SIZE - TRAINING_OFFSET:],
                         x[..., :FRAME_SIZE - TRAINING_OFFSET]], dim=-1)
    _, band_e, new_analysis_mem = spectrum.frame_analysis(x, state.analysis_mem)
    ceps = spectrum.cepstrum_from_band_energy(band_e)
    lpc = lpc_from_cepstrum(ceps)

    exc, new_pitch_mem, new_pitch_filt = _excitation(
        aligned, lpc, state.pitch_mem, state.pitch_filt)
    exc_buf = torch.cat([state.exc_buf[..., FRAME_SIZE:], exc], dim=-1)
    xc0, w0 = pitch_mod.half_frame_xcorr(exc_buf, 0)
    xc1, w1 = pitch_mod.half_frame_xcorr(exc_buf, TRAINING_OFFSET)
    xc, fw = state.xc.clone(), state.frame_weight.clone()
    lo = 2 + 2 * pcount
    xc[:, lo], xc[:, lo + 1] = xc0, xc1
    fw[:, lo], fw[:, lo + 1] = w0, w1

    feats = frame.new_zeros(frame.shape[:-1] + (NB_TOTAL_FEATURES,),
                            dtype=torch.float32)
    feats[..., :NB_BANDS] = ceps
    feats[..., NB_BANDS + 2:] = lpc
    return state._replace(
        analysis_mem=new_analysis_mem, mem_preemph=new_preemph,
        pitch_mem=new_pitch_mem, pitch_filt=new_pitch_filt,
        exc_buf=exc_buf, xc=xc, frame_weight=fw), feats


def normalized_frame_weights(fw: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    w = fw[..., lo:lo + n]
    return w * (n / (1e-15 + w.sum(-1, keepdim=True)))


def compute_single_frame_features(state: EncoderState, frame: torch.Tensor
                                  ) -> Tuple[EncoderState, torch.Tensor]:
    """The per-frame feature path with the 2-subframe Viterbi
    (src/lpcnet_enc.c:814-870, 919-925): frame [B, 160] raw float PCM ->
    (state, features [B, 36])."""
    state, feats = frame_features_step(state, frame, 0)
    w = normalized_frame_weights(state.frame_weight, 2, 2)
    xcs = pitch_mod.octave_suppress(state.xc[:, 2:4])
    carry, periods, corr = pitch_mod.viterbi_track(state.viterbi, xcs, w)
    psum = periods[..., 0] + periods[..., 1]
    feats[..., NB_BANDS] = 0.01 * (torch.clamp(psum, 66, 510).to(torch.float32)
                                   - 200.0)
    feats[..., NB_BANDS + 1] = corr - 0.5
    xc_new = state.xc.clone()
    xc_new[:, 2:4] = xcs
    return state._replace(xc=xc_new, viterbi=carry), feats


def compute_single_frame_features_seq(state: EncoderState, pcm: torch.Tensor):
    """pcm [B, T*160] -> (state, features [B, T, 36]), frame by frame."""
    t = pcm.shape[-1] // FRAME_SIZE
    rows = []
    for k in range(t):
        state, f = compute_single_frame_features(
            state, pcm[..., k * FRAME_SIZE:(k + 1) * FRAME_SIZE])
        rows.append(f)
    return state, torch.stack(rows, dim=1)


def _leaves(state: EncoderState):
    """The tensors of `state` in field order, the ViterbiCarry's in its
    place."""
    return [t for f in state for t in (f if isinstance(f, tuple) else (f,))]


def _clone_state(state: EncoderState) -> EncoderState:
    """A dense copy of `state`, the ViterbiCarry's tensors included."""
    dense = lambda t: t.clone(memory_format=torch.contiguous_format)
    return EncoderState(*(type(f)(*map(dense, f)) if isinstance(f, tuple)
                          else dense(f) for f in state))


class AnalysisGraph:
    """Two `compute_single_frame_features` calls (one 20 ms tick of 320
    samples) as one CUDA graph, for a caller that runs them at one batch
    every tick (`runtime.serving.DREDEncoderPool`): `g(state, pcm)`, pcm
    [B, 320] float32, returns (new_state, f0, f1), f0 and f1 [B, 36], as
    the two plain calls on pcm[:, :160] and pcm[:, 160:] do. On CUDA it
    copies the PCM (and a state that is not the graph's own) into the
    graph's inputs and replays the graph, in place of ~2,200 operator
    calls from the host.

    On CPU tensors a call is the two plain calls. On CUDA the first call
    captures: a few eager calls on a throwaway copy of the state, on a side
    stream (cuBLAS handles, the cuFFT plan of `rfft`, the device
    constants), then one captured call. A call captures again when the
    PCM's shape, dtype or device, the state's shapes and dtypes, or the
    TF32 flag differ from what the graph was captured with. Inside a CUDA
    stream capture of the caller's a call runs eagerly, so it is captured
    with the rest.

    The graph reads and writes its own state buffers, every leaf of the
    ViterbiCarry among them: a call returns them as the new state, written
    in place, and f0 and f1 are the graph's outputs; all of them are valid
    until the next call. The cuFFT plan it replays lives in PyTorch's plan
    cache (cleared or overfull, the graph would read a freed plan).

    Counters (CUDA calls only), in `stats` (a `collections.Counter`, the
    caller's if given): `analysis_captures`, `analysis_replays`, and
    `analysis_eager` (calls run eagerly inside a caller's capture). Every
    CUDA call outside one replays, the first included.
    """

    WARMUP = 3

    def __init__(self, stats: Optional[collections.Counter] = None):
        self.stats = collections.Counter() if stats is None else stats
        self._key = None
        self._graph = None

    def __call__(self, state: EncoderState, pcm: torch.Tensor):
        if not pcm.is_cuda:
            return self._plain(state, pcm)
        if torch.cuda.is_current_stream_capturing():
            self.stats["analysis_eager"] += 1
            return self._plain(state, pcm)
        key = (pcm.shape, pcm.dtype, pcm.device,
               tuple((t.shape, t.dtype) for t in _leaves(state)),
               torch.backends.cuda.matmul.allow_tf32)
        if key != self._key:
            self._capture(state, pcm)
            self._key = key
        graph, st_in, pcm_in, out = self._graph
        for buf, given in zip(_leaves(st_in), _leaves(state)):
            if given is not buf:
                buf.copy_(given)
        pcm_in.copy_(pcm)
        graph.replay()
        self.stats["analysis_replays"] += 1
        return (st_in,) + out

    @staticmethod
    def _plain(state, pcm):
        state, f0 = compute_single_frame_features(state, pcm[:, :FRAME_SIZE])
        state, f1 = compute_single_frame_features(state, pcm[:, FRAME_SIZE:])
        return state, f0, f1

    @staticmethod
    def _body(state, pcm):
        """The two plain calls with the new state written into `state`."""
        new, f0, f1 = AnalysisGraph._plain(state, pcm)
        for buf, val in zip(_leaves(state), _leaves(new)):
            if val is not buf:
                buf.copy_(val)
        return f0, f1

    def _capture(self, state, pcm):
        self._graph = None                   # the old graph's pool goes
        dev = pcm.device
        st_in = _clone_state(state)
        pcm_in = pcm.clone(memory_format=torch.contiguous_format)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.stream(side):
            scratch = _clone_state(st_in)
            for _ in range(self.WARMUP):
                self._body(scratch, pcm_in)
            with torch.cuda.graph(graph, stream=side):
                out = self._body(st_in, pcm_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._graph = (graph, st_in, pcm_in, out)
        self.stats["analysis_captures"] += 1


def superframe_pitch(state: EncoderState):
    """The pitch half of process_superframe, unquantised
    (src/lpcnet_enc.c:602-700): (new_state, period_feat [B, 4], frame_corr
    [B]). Rotates the correlation ring and carries the Viterbi state."""
    w = normalized_frame_weights(state.frame_weight, 2, 8)      # [B, 8]
    xcs = pitch_mod.octave_suppress(state.xc[:, 2:10])
    carry, periods, corr = pitch_mod.viterbi_track(state.viterbi, xcs, w)
    # a frame's period is its two half-frames' sum, clamped (:693)
    psum = periods[..., 0::2] + periods[..., 1::2]              # [B, 4]
    period_feat = 0.01 * (torch.clamp(psum, 66, 510).to(torch.float32)
                          - 200.0)
    return state._replace(xc=rotate_xc(state.xc, xcs),
                          viterbi=carry), period_feat, corr


def rotate_xc(xc, xcs):
    """The ring after a superframe: slots 2..9 the suppressed correlations,
    slots 0, 1 the last two of them."""
    xc = xc.clone()
    xc[:, 2:10] = xcs
    xc[:, 0:2] = xcs[:, 6:8]
    return xc


def compute_features_superframe(state: EncoderState, pcm: torch.Tensor
                                ) -> Tuple[EncoderState, torch.Tensor]:
    """Unquantised features of one 40 ms superframe: pcm [B, 640] ->
    (state, features [B, 4, 36]), as lpcnet_compute_features
    (src/lpcnet_enc.c:895-909)."""
    state, feats = superframe_analysis(state, pcm)
    state, period_feat, corr = superframe_pitch(state)
    feats[..., NB_BANDS] = period_feat
    feats[..., NB_BANDS + 1] = corr[:, None] - 0.5
    return state._replace(vq_mem=feats[:, 3, :NB_BANDS]), feats


def compute_features(state: EncoderState, pcm: torch.Tensor):
    """pcm [B, T*640] -> (state, features [B, T, 4, 36]), superframe by
    superframe."""
    t = pcm.shape[-1] // (4 * FRAME_SIZE)
    out = []
    for k in range(t):
        state, f = compute_features_superframe(
            state, pcm[..., k * 4 * FRAME_SIZE:(k + 1) * 4 * FRAME_SIZE])
        out.append(f)
    return state, torch.stack(out, dim=1)


def superframe_analysis(state: EncoderState, pcm: torch.Tensor):
    """A superframe's four 10 ms frames in batched operations: one FFT
    batch, one Levinson batch, one excitation product over 640 samples, one
    correlation product per half-frame of all four frames.

    pcm [B, 640] raw float PCM. Returns (new_state, feats [B, 4, 36]) with
    the pitch columns zero."""
    b = pcm.shape[0]
    x, new_preemph = preemphasis(pcm.to(torch.float32), state.mem_preemph)
    # 4 overlapping 320-sample windows of [analysis_mem | x]
    ext = torch.cat([state.analysis_mem, x], dim=-1)            # [B, 800]
    wins = ext.unfold(-1, 2 * FRAME_SIZE, FRAME_SIZE)           # [B, 4, 320]
    spec = spectrum.forward_transform(spectrum.apply_window(wins))
    ceps = spectrum.cepstrum_from_band_energy(
        spectrum.compute_band_energy(spec))                     # [B, 4, 18]
    lpc = lpc_from_cepstrum(ceps)                               # [B, 4, 16]

    # the half-frame-aligned signal: frame k's is ext2[k*160 : k*160+160]
    ext2 = torch.cat([state.analysis_mem[..., OVERLAP_SIZE - TRAINING_OFFSET:],
                      x[..., :4 * FRAME_SIZE - TRAINING_OFFSET]], dim=-1)
    hist = torch.cat([torch.flip(state.pitch_mem, (-1,)), ext2], dim=-1)
    # excitation FIR per frame, as `_excitation`: [B, 4, 160, 17] windows
    awins = hist.unfold(-1, LPC_ORDER + 1, 1)[:, :4 * FRAME_SIZE].reshape(
        b, 4, FRAME_SIZE, LPC_ORDER + 1)
    coeffs = torch.cat([torch.flip(lpc, (-1,)),
                        torch.ones_like(lpc[..., :1])], dim=-1)  # [B, 4, 17]
    s = torch.matmul(awins, coeffs[..., None])[..., 0].reshape(b, -1)
    s_prev = torch.cat([state.pitch_filt[..., None], s[..., :-1]], dim=-1)
    exc = s + 0.7 * s_prev                                      # [B, 640]

    full_exc = torch.cat([state.exc_buf, exc], dim=-1)          # [B, 1056]
    # each frame's live excitation buffer: 416 samples ending at its end
    views = full_exc.unfold(-1, EXC_BUF_SIZE, FRAME_SIZE)[:, 1:]  # [B, 4, 416]
    views = views.reshape(b * 4, EXC_BUF_SIZE)
    xc0, w0 = pitch_mod.half_frame_xcorr(views, 0)
    xc1, w1 = pitch_mod.half_frame_xcorr(views, TRAINING_OFFSET)
    xc, fw = state.xc.clone(), state.frame_weight.clone()
    xc[:, 2:10] = torch.stack([xc0, xc1], dim=1).reshape(b, 8, -1)
    fw[:, 2:10] = torch.stack([w0, w1], dim=1).reshape(b, 8)

    feats = pcm.new_zeros((b, 4, NB_TOTAL_FEATURES), dtype=torch.float32)
    feats[..., :NB_BANDS] = ceps
    feats[..., NB_BANDS + 2:] = lpc
    return state._replace(
        analysis_mem=x[..., -OVERLAP_SIZE:], mem_preemph=new_preemph,
        pitch_mem=torch.flip(ext2[..., -LPC_ORDER:], (-1,)),
        pitch_filt=s[..., -1], exc_buf=full_exc[..., -EXC_BUF_SIZE:],
        xc=xc, frame_weight=fw), feats
