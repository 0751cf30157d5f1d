"""Batched 1.6 kb/s encoder: pcm -> features -> quantized superframe ->
packet, as lpcnet_encode / process_superframe(encode=1, quantize=1)
(src/lpcnet_enc.c:579-743, :882-893) over a stream batch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..dsp import pitch as pitch_mod
from ..dsp.constants import NB_BANDS
from ..dsp.lpc import lpc_from_cepstrum
from ..utils.device import resolve_device
from . import features as F
from . import packet as P
from . import quantize as Q
from .codebooks import Codebooks, load_codebooks


def encode_superframe(state: F.EncoderState, pcm: torch.Tensor,
                      cbs: Codebooks
                      ) -> Tuple[F.EncoderState, torch.Tensor,
                                 Dict[str, torch.Tensor]]:
    """One 40 ms superframe: pcm [B, 640] -> (state, quantized features
    [B, 4, 36], wire fields {name: [B] int})."""
    state, feats = F.superframe_analysis(state, pcm)

    w = F.normalized_frame_weights(state.frame_weight, 2, 8)
    xcs = pitch_mod.octave_suppress(state.xc[:, 2:10])
    carry, periods, corr = pitch_mod.viterbi_track(state.viterbi, xcs, w)
    corr = torch.clamp(corr, min=0.0)                 # the quantize path's clamp

    pq = Q.quantize_pitch(periods.to(torch.float32), w, corr)
    feats[..., NB_BANDS] = pq.period_feat
    feats[..., NB_BANDS + 1] = pq.corr_feat[:, None]

    f3 = feats[:, 3, :NB_BANDS]
    c0_id, f3c0 = Q.quantize_c0(f3[:, 0])
    vq_end, recon3 = Q.quantize_3stage_mbest(f3[:, 1:], cbs.stage1,
                                             cbs.stage2, cbs.stage3)
    f3q = torch.cat([f3c0[:, None], recon3], dim=-1)

    vq_mid, f1q = Q.quantize_diff(feats[:, 1, :NB_BANDS], state.vq_mem, f3q,
                                  cbs.diff4)
    interp_id = Q.double_interp_search(feats[:, 0, :NB_BANDS],
                                       feats[:, 2, :NB_BANDS], state.vq_mem,
                                       f1q, f3q)
    f0q, f2q = Q.apply_double_interp(state.vq_mem, f1q, f3q, interp_id)

    ceps_q = torch.stack([f0q, f1q, f2q, f3q], dim=1)  # [B, 4, 18]
    feats[..., :NB_BANDS] = ceps_q
    feats[..., NB_BANDS + 2:] = lpc_from_cepstrum(ceps_q)

    state = state._replace(xc=F.rotate_xc(state.xc, xcs), viterbi=carry,
                           vq_mem=f3q)
    fields = {
        "c0_id": c0_id + 64,
        "main_pitch": pq.main_pitch,
        "modulation": torch.where(pq.voiced, pq.modulation + 4, 0),
        "corr_id": pq.corr_id,
        "vq_end0": vq_end[:, 0],
        "vq_end1": vq_end[:, 1],
        "vq_end2": vq_end[:, 2],
        "vq_mid": vq_mid,
        "interp": interp_id,
    }
    return state, feats, fields


class LPCNetEncoder:
    """Stateful batched encoder with the C API's shape (lpcnet_encode). Runs
    on CUDA unless `device="cpu"` is passed."""

    def __init__(self, batch: int = 1, device=None):
        self.batch = batch
        self.device = resolve_device(device)
        self.cbs = load_codebooks(device=self.device)
        self.reset()

    def reset(self):
        self.state = F.init_encoder_state(self.batch, self.device)
        # the quantized features [B, 4, 36] of the last encoded superframe:
        # what a decoder reconstructs from its packets
        self.quantized = None

    def _pcm(self, pcm) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pcm, np.float32), device=self.device)

    def encode(self, pcm: np.ndarray) -> np.ndarray:
        """pcm [B, 640] int16 or float -> [B, 8] uint8 packets."""
        with torch.no_grad():
            self.state, self.quantized, fields = encode_superframe(
                self.state, self._pcm(pcm), self.cbs)
        return P.pack_fields({k: v.cpu().numpy() for k, v in fields.items()})

    def compute_features(self, pcm: np.ndarray) -> np.ndarray:
        """Unquantized features: pcm [B, T*640] -> [B, T, 4, 36]."""
        with torch.no_grad():
            self.state, feats = F.compute_features(self.state, self._pcm(pcm))
        return feats.cpu().numpy()

    def compute_single_frame_features(self, pcm: np.ndarray) -> np.ndarray:
        """The per-frame path: pcm [B, 160] -> features [B, 36]."""
        with torch.no_grad():
            self.state, feats = F.compute_single_frame_features(
                self.state, self._pcm(pcm))
        return feats.cpu().numpy()
