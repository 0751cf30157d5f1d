"""Quantizers of the 1.6 kb/s codec, batched over streams: the m-best VQ
beam, the diff VQ, the interpolation search, pitch and c0 (the encoder's
half), and their inverses (the decoder's half).

Every function takes a leading stream axis [B, ...] (the JAX package vmaps
single-stream functions instead). Bit-exactness against the reference rests
on integer decisions over float32 distances, with the reference's scan
orders and tie-breaking (src/lpcnet_enc.c:53-241, :283-425):

* `torch.argmin` returns the first minimum, as the C's strict-< scans do;
  `_top_m_small` is an argmin loop for that reason (`torch.topk` does not
  promise an order among ties);
* the reference's survivor merge keeps incumbents ahead on ties and takes
  the stage-1 survivors in order, which is a stable sort over candidates
  flattened in (survivor, rank) order: `torch.sort(stable=True)`.

Distances are float32 products |x|^2 - 2 x.c + |c|^2, as in the JAX
package; on the card TF32 must stay off (`utils.device.resolve_device` pins
it off).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..dsp.constants import NB_BANDS

SURVIVORS = 5
FORBIDDEN_INTERP = 7


def _dists(x, codebook):
    """Squared euclidean distances of x [..., d] to codebook rows [n, d]:
    [..., n]."""
    cb_sq = (codebook * codebook).sum(-1)
    xsq = (x * x).sum(-1, keepdim=True)
    return xsq - 2.0 * torch.matmul(x, codebook.T) + cb_sq


def _top_m_small(d, m: int):
    """The m smallest of d [..., n], ascending, first index on ties: (values,
    indices [..., m] int64)."""
    vals, idxs = [], []
    d = d.clone()
    for _ in range(m):
        i = torch.argmin(d, dim=-1, keepdim=True)
        vals.append(d.gather(-1, i)[..., 0])
        idxs.append(i[..., 0])
        d.scatter_(-1, i, float("inf"))
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def vq_mbest(codebook, x, m: int = SURVIVORS):
    """m best codewords of x [B, d], ascending distance (vq_quantize_mbest,
    :53-78)."""
    return _top_m_small(_dists(x, codebook), m)


def _beam_merge(flat_d, m: int = SURVIVORS):
    """Stable smallest-m over candidates [B, K] flattened in arrival order."""
    return torch.sort(flat_d, dim=-1, stable=True).indices[..., :m]


def quantize_3stage_mbest(x, cb1, cb2, cb3):
    """3-stage m-best cepstral VQ (quantize_3stage_mbest, :133-241).

    x [B, 17] (cepstral dims 1..17 of the endpoint frame). Returns (indices
    [B, 3] int32, reconstruction [B, 17])."""
    s = SURVIVORS
    _, i1 = vq_mbest(cb1, x)                              # [B, S]
    r1 = x[:, None, :] - cb1[i1]                          # [B, S, 17]
    d2_top, i2_top = _top_m_small(_dists(r1, cb2), s)     # [B, S, S]
    sel = _beam_merge(d2_top.flatten(1))                  # [B, S]
    pair1 = i1.gather(1, sel // s)
    pair2 = i2_top.flatten(1).gather(1, sel)

    r2 = x[:, None, :] - cb1[pair1] - cb2[pair2]          # [B, S, 17]
    d3_top, i3_top = _top_m_small(_dists(r2, cb3), s)
    best = _beam_merge(d3_top.flatten(1))[:, :1]          # [B, 1]
    b1 = pair1.gather(1, best // s)[:, 0]
    b2 = pair2.gather(1, best // s)[:, 0]
    b3 = i3_top.flatten(1).gather(1, best)[:, 0]
    recon = cb1[b1] + cb2[b2] + cb3[b3]
    return torch.stack([b1, b2, b3], dim=-1).to(torch.int32), recon


def _interp_preds(left, right):
    """The 4 interpolation predictors [B, 4, 18] (src/lpcnet_enc.c:294-296)."""
    mean = 0.5 * (left + right)
    return torch.stack([mean, mean, left, right], dim=1)


def quantize_diff(x, left, right, codebook):
    """Signed multi-predictor diff VQ of the mid frame (quantize_diff,
    :283-318). x, left, right [B, 18]. Entry i's low 2 bits select its
    predictor; the sign adds n. Returns (entry [B] int32 in [0, 2n),
    reconstruction [B, 18])."""
    preds = _interp_preds(left, right)                    # [B, 4, 18]
    n = codebook.shape[0]
    # entries with (i & 3) == g share the predictor, so d_i = |t_g|^2 -+
    # 2 t_g.c_i + |c_i|^2 with t_g = x - preds[g]: one product covers all
    t = x[:, None, :] - preds                             # [B, 4, 18]
    cb_sq = (codebook * codebook).sum(-1)                 # [n]
    cross = torch.matmul(t, codebook.T)                   # [B, 4, n]
    tsq = (t * t).sum(-1)                                 # [B, 4]
    group = torch.arange(n, device=x.device) & 3
    cross_g = cross.gather(1, group.expand(x.shape[0], 1, n))[:, 0]
    tsq_g = tsq[:, group]
    d_all = torch.cat([tsq_g - 2.0 * cross_g + cb_sq,
                       tsq_g + 2.0 * cross_g + cb_sq], dim=-1)
    entry = torch.argmin(d_all, dim=-1)
    idx = entry & (n - 1)
    sign = torch.where(entry >= n, -1.0, 1.0)
    rows = torch.arange(x.shape[0], device=x.device)
    recon = preds[rows, idx & 3] + sign[:, None] * codebook[idx]
    return entry.to(torch.int32), recon


def interp_dists(x, left, right):
    """Distances [B, 3] of x to the 3 distinct predictors [mean, left, right]
    (interp_search, :320-340)."""
    preds = torch.stack([0.5 * (left + right), left, right], dim=1)
    return ((x[:, None, :NB_BANDS] - preds[..., :NB_BANDS]) ** 2).sum(-1)


def double_interp_search(f0, f2, mem, f1, f3):
    """Joint interpolation id of frames 0 and 2 (src/lpcnet_enc.c:379-400):
    the coded id [B] int32 (0..7, the forbidden combination skipped)."""
    d0 = interp_dists(f0, mem, f1)
    d1 = interp_dists(f2, f1, f3)
    flat = (d0[:, :, None] + d1[:, None, :]).flatten(1)   # [B, 9], id 3i+j
    flat[:, FORBIDDEN_INTERP] = float("inf")
    best = torch.argmin(flat, dim=-1)
    return (best - (best >= FORBIDDEN_INTERP).long()).to(torch.int32)


def apply_double_interp(mem, f1, f3, coded_id):
    """Frames 0 and 2 from the coded interpolation id [B]
    (perform_double_interp, src/common.c:58-65). Returns (f0, f2) [B, 18]."""
    coded_id = coded_id.long()
    best = coded_id + (coded_id >= FORBIDDEN_INTERP).long()
    rows = torch.arange(mem.shape[0], device=mem.device)
    p0 = torch.stack([0.5 * (mem + f1), mem, f1], dim=1)
    p2 = torch.stack([0.5 * (f1 + f3), f1, f3], dim=1)
    return p0[rows, best // 3], p2[rows, best % 3]


class PitchQuant(NamedTuple):
    main_pitch: torch.Tensor   # [B] int32 0..63
    modulation: torch.Tensor   # [B] int32 -3..3
    corr_id: torch.Tensor      # [B] int32 (cut to 2 bits when packed)
    voiced: torch.Tensor       # [B] bool
    period_feat: torch.Tensor  # [B, 4] quantized feature column 18
    corr_feat: torch.Tensor    # [B] quantized (frame_corr - 0.5)


def _pitch_features(main_pitch, modulation, corr_id, voiced):
    """(period_feat [B, 4], corr_feat [B]) of quantized pitch fields
    (src/lpcnet_dec.c:113-129, src/lpcnet_enc.c:683-697)."""
    qcorr = torch.where(voiced, 0.3875 + 0.175 * corr_id,
                        0.0375 + 0.075 * corr_id)
    subs = torch.arange(4, dtype=torch.float32, device=main_pitch.device)
    p = torch.pow(2.0, main_pitch.to(torch.float32) / 21.0) * 32.0
    p = p[:, None] * (1.0 + modulation.to(torch.float32)[:, None] / 16.0 / 7.0
                      * (2.0 * subs - 3.0))
    p = torch.clamp(p, 33.0, 255.0)
    return 0.02 * (p - 100.0), qcorr - 0.5


def quantize_pitch(periods, weights, frame_corr) -> PitchQuant:
    """Pitch contour quantization (src/lpcnet_enc.c:645-697).

    periods [B, 8] float half-frame Viterbi periods; weights [B, 8]
    normalised frame weights; frame_corr [B] (clamped >= 0 by the caller)."""
    sub = torch.arange(2.0, 10.0, device=periods.device)
    w = weights
    sw = w.sum(-1)
    sx = (w * sub).sum(-1)
    sxx = (w * sub * sub).sum(-1)
    sxy = (w * sub * periods).sum(-1)
    sy = (w * periods).sum(-1)
    best_a = (sw * sxy - sx * sy) / (sw * sxx - sx * sx)
    voiced = frame_corr >= 0.3
    max_a = sy / sw / 32.0
    best_a = torch.where(voiced,
                         torch.minimum(torch.maximum(best_a, -max_a), max_a),
                         0.0)
    corr_id = torch.where(voiced, torch.floor((frame_corr - 0.3) / 0.175),
                          torch.floor(frame_corr / 0.075)).to(torch.int32)
    best_b = (sy - best_a * sx) / sw
    center = best_b + 5.5 * best_a
    main_pitch = torch.floor(0.5 + 21.0 * 1.442695041
                             * torch.log(center / 32.0))
    main_pitch = torch.clamp(main_pitch, 0, 63).to(torch.int32)
    modulation = torch.floor(0.5 + 16.0 * 7.0 * best_a / center)
    modulation = torch.clamp(modulation, -3, 3).to(torch.int32)
    period_feat, corr_feat = _pitch_features(main_pitch, modulation, corr_id,
                                             voiced)
    return PitchQuant(main_pitch, modulation, corr_id, voiced, period_feat,
                      corr_feat)


def quantize_c0(c0):
    """7-bit scalar of the DC cepstral coefficient [B]
    (src/lpcnet_enc.c:704-706): (c0_id int32, its value)."""
    c0_id = torch.clamp(torch.floor(0.5 + c0 * 4.0), -64, 63).to(torch.int32)
    return c0_id, c0_id.to(torch.float32) / 4.0


def dequantize_pitch(main_pitch, modulation, corr_id, voiced):
    """The decoder's side (src/lpcnet_dec.c:113-129): fields [B] ->
    (period_feat [B, 4], corr_feat [B])."""
    return _pitch_features(main_pitch, modulation, corr_id, voiced)
