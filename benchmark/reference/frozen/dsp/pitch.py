# Frozen copy of lpcnet_torch/dsp/pitch.py at commit d7e6271, kept to its plain
# paths. Part of the benchmark's yardstick: not to be edited.
"""Pitch estimation: excitation cross-correlation and Viterbi tracking,
batched over streams.

* half-frame normalised cross-correlation with 3x sinc-interpolated peak
  sharpening (src/lpcnet_enc.c:539-570, src/pitch.c:44-83),
* per-subframe Viterbi tracking with octave suppression, +-4 lag
  transitions at a quadratic cost and a "restart" path 6 below the running
  best (src/lpcnet_enc.c:604-643).

Every function takes a leading stream axis. Lags are indexed as
i = PITCH_MAX_PERIOD - period. The JAX package's one-hot reductions in the
backward pass are gathers here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .constants import (FRAME_SIZE, PITCH_INTERP, PITCH_MAX_PERIOD,
                        PITCH_MIN_PERIOD)

N_LAGS = PITCH_MAX_PERIOD                       # 256 correlation lags
N_STATES = PITCH_MAX_PERIOD - PITCH_MIN_PERIOD  # 224 Viterbi states
_TAPS = [float(t) for t in PITCH_INTERP]


def half_frame_xcorr(exc_buf: torch.Tensor, offset: int):
    """Normalised cross-correlation of one 80-sample half-frame.

    exc_buf [B, 416] excitation history, the current frame in its last 160
    samples; offset 0 or 80. Returns (xc [B, 256], ener0 [B] frame weight).
    """
    half = FRAME_SIZE // 2
    cur = exc_buf[:, PITCH_MAX_PERIOD + offset:PITCH_MAX_PERIOD + offset + half]
    # windows[:, i] = exc_buf[:, offset+i : offset+i+80]
    windows = exc_buf.unfold(-1, half, 1)[:, offset:offset + N_LAGS]
    xcorr = torch.matmul(windows, cur[:, :, None])[:, :, 0]
    ener0 = (cur * cur).sum(-1)
    ener1 = (windows * windows).sum(-1)
    xc = 2.0 * xcorr / (1.0 + ener0[:, None] + ener1)
    # 3x sinc interpolation as shifted adds in plain float32 (a cuDNN
    # convolution would round the operands to TF32 by default); zeros
    # beyond the ends. val1[i] = sum_m xc[i-3+m] h[m], val2[i] = sum_m
    # xc[i+3-m] h[m]
    xp = torch.nn.functional.pad(xc, (3, 3))
    val1 = sum(xp[:, m:m + N_LAGS] * _TAPS[m] for m in range(7))
    val2 = sum(xp[:, 6 - m:6 - m + N_LAGS] * _TAPS[m] for m in range(7))
    interp = torch.maximum(xc, torch.maximum(val1, val2))
    i = torch.arange(N_LAGS, device=xc.device)
    keep = (i >= 4) & (i < N_LAGS - 4)
    return torch.where(keep, interp, xc), ener0


def octave_suppress(xc: torch.Tensor) -> torch.Tensor:
    """Attenuate lags whose half-lag correlation is nearly as strong
    (src/lpcnet_enc.c:607-610): for i < 192, if xc[i] < 1.1*max(xc[(256+i)/2],
    xc[(256+i+2)/2], xc[(256+i-1)/2]) then xc[i] *= .8. The reads hit
    entries that are not modified yet, so the update is parallel.
    xc [..., 256]."""
    i = torch.arange(N_LAGS, device=xc.device)
    pick = lambda j: xc[..., torch.clamp(j, 0, N_LAGS - 1)]
    xc_half = torch.maximum(pick((N_LAGS + i) // 2), torch.maximum(
        pick((N_LAGS + i + 2) // 2), pick((N_LAGS + i - 1) // 2)))
    active = i < (PITCH_MAX_PERIOD - 2 * PITCH_MIN_PERIOD)
    shrink = active & (xc < xc_half * 1.1)
    return torch.where(shrink, xc * 0.8, xc)


class ViterbiCarry(NamedTuple):
    """Viterbi state carried from frame to frame. `path` is renormalised
    (its max is 0) while `path_max` keeps the unnormalised max of the last
    subframe: the reference compares the restart path `path_max - 6` with
    renormalised metrics (src/lpcnet_enc.c:614, :629-633)."""
    path: torch.Tensor       # [B, N_STATES]
    path_max: torch.Tensor   # [B]
    best_i: torch.Tensor     # [B] int32, argmax state of the last subframe

    @staticmethod
    def zeros(batch: int, device="cpu"):
        return ViterbiCarry(
            path=torch.zeros(batch, N_STATES, dtype=torch.float32, device=device),
            path_max=torch.zeros(batch, dtype=torch.float32, device=device),
            best_i=torch.zeros(batch, dtype=torch.int32, device=device))


def viterbi_step(carry: ViterbiCarry, xc: torch.Tensor, weight: torch.Tensor):
    """One subframe: xc [B, 256] octave-suppressed correlation, weight [B]
    normalised frame weight. Returns (new_carry, prev_idx [B, N_STATES]
    int32 backpointers). Among equal candidates the first wins (restart,
    then jumps -4..4), which is the C's strict `>` scan."""
    i = torch.arange(N_STATES, device=xc.device)
    padded = torch.nn.functional.pad(carry.path, (4, 4), value=float("-inf"))
    cands = [(carry.path_max - 6.0)[:, None].expand(-1, N_STATES)]
    for j in range(-4, 5):
        cands.append(padded[:, 4 + j:4 + j + N_STATES] - 0.02 * j * j)
    vals = torch.stack(cands, dim=1)                      # [B, 10, N_STATES]
    max_prev, choice = torch.max(vals, dim=1)
    prev_idx = torch.where(choice == 0, carry.best_i[:, None].long(),
                           i[None, :] + choice - 5).to(torch.int32)
    path1 = max_prev + weight[:, None] * xc[:, :N_STATES]
    max_all, best = torch.max(path1, dim=1)
    return (ViterbiCarry(path1 - max_all[:, None], max_all,
                         best.to(torch.int32)), prev_idx)


def viterbi_track(carry: ViterbiCarry, xcs: torch.Tensor,
                  weights: torch.Tensor):
    """n_sub subframes of tracking and the backward pass: xcs [B, n_sub, 256]
    (octave-suppressed), weights [B, n_sub]. Returns (new_carry, periods
    [B, n_sub] int32, frame_corr [B])."""
    n_sub = xcs.shape[1]
    prevs = []
    for sub in range(n_sub):
        carry, prev = viterbi_step(carry, xcs[:, sub], weights[:, sub])
        prevs.append(prev)
    best_i = carry.best_i.long()
    periods, corr = [], 0.0
    for sub in range(n_sub - 1, -1, -1):
        periods.append(PITCH_MAX_PERIOD - best_i)
        corr = corr + weights[:, sub] * xcs[:, sub].gather(
            1, best_i[:, None])[:, 0]
        best_i = prevs[sub].gather(1, best_i[:, None])[:, 0].long()
    periods = torch.stack(periods[::-1], dim=1).to(torch.int32)
    return carry, periods, corr / n_sub
