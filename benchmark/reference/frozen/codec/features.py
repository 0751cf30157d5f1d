# Frozen copy of lpcnet_torch/codec/features.py at commit d7e6271, kept to its plain
# paths. Part of the benchmark's yardstick: not to be edited.
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
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

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
