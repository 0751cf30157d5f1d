# Frozen copy of lpcnet_torch/codec/quantize.py at commit d7e6271, kept to its plain
# paths. Part of the benchmark's yardstick: not to be edited.
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

import torch


SURVIVORS = 5
FORBIDDEN_INTERP = 7


def apply_double_interp(mem, f1, f3, coded_id):
    """Frames 0 and 2 from the coded interpolation id [B]
    (perform_double_interp, src/common.c:58-65). Returns (f0, f2) [B, 18]."""
    coded_id = coded_id.long()
    best = coded_id + (coded_id >= FORBIDDEN_INTERP).long()
    rows = torch.arange(mem.shape[0], device=mem.device)
    p0 = torch.stack([0.5 * (mem + f1), mem, f1], dim=1)
    p2 = torch.stack([0.5 * (f1 + f3), f1, f3], dim=1)
    return p0[rows, best // 3], p2[rows, best % 3]


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


def dequantize_pitch(main_pitch, modulation, corr_id, voiced):
    """The decoder's side (src/lpcnet_dec.c:113-129): fields [B] ->
    (period_feat [B, 4], corr_feat [B])."""
    return _pitch_features(main_pitch, modulation, corr_id, voiced)
