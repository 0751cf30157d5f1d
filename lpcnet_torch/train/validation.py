"""Held-out validation for vocoder training runs: the counterpart of
`lpcnet_tpu/train/validation.py`.

A long run can degrade held-out quality while its training loss falls, and
nothing in a loop that tracks only the loss notices. `HeldOutValidator`
holds a few fixed clips, computes their feature tracks once (the analysis
does not depend on the model), and on `evaluate` synthesises every segment
from those features and scores it against the original with the repo's
intrusive proxies (band-LSD, MCD, fwSegSNR; `utils/quality.py`). The
sampler's RNG starts from the same seed at every call, so the curve is
comparable from step to step.

Synthesis is frame by frame: the frame network, then one frame of the
sample loop. On the CPU the loop is the plain `models.lpcnet.
synthesize_frame`, the counterpart of the JAX package's scan; on CUDA it is
one launch of the sample-loop kernel a frame (K1, `kernels.sample_loop.
synthesize_frame_kernel`) on a float32 bundle rebuilt from the params at each
call with its kernel packs (`masked_kernel_weights`, once a call, not once
a frame), float32 so that it stays the counterpart of that float32 scan.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device

FRAME = 160


class HeldOutValidator:
    """Fixed-clip analysis / synthesis evaluation.

    Args:
      cfg: LPCNetConfig of the model under training.
      clips: held-out PCM clips (int16 arrays); each is cut into
        `seg_seconds` segments and all segments run as one stream batch.
      seg_seconds: segment length; each segment starts from silence (the
        edge effect is the same for every checkpoint compared).
      device: CUDA unless "cpu" is passed.
    """

    def __init__(self, cfg, clips: Sequence[np.ndarray],
                 seg_seconds: float = 2.0, device=None):
        from ..codec import features as F

        self.cfg = cfg
        self.device = resolve_device(device)
        # the sample loop: the plain synthesize_frame on the CPU, the kernel
        # on CUDA
        self.use_kernel = self.device.type != "cpu"
        seg_len = int(seg_seconds * 16000) // FRAME * FRAME
        segs = []
        self._clip_of_seg: List[int] = []
        for ci, clip in enumerate(clips):
            pcm = np.asarray(clip, np.float32)
            n = len(pcm) // seg_len
            if n == 0:
                raise ValueError(
                    f"clip {ci} too short: need >= {seg_len} samples")
            segs.append(pcm[: n * seg_len].reshape(n, seg_len))
            self._clip_of_seg += [ci] * n
        self._orig = np.concatenate(segs, axis=0)           # [B, S]
        b, s = self._orig.shape
        self._b, self._t = b, s // FRAME

        # the analysis, once: the features do not depend on the params
        enc = F.init_encoder_state(b, self.device)
        with torch.no_grad():
            _, feats = F.compute_single_frame_features_seq(
                enc, torch.from_numpy(self._orig).to(self.device))
        self.features = feats                               # [B, T, 36]

    def synthesize(self, params) -> np.ndarray:
        """Every segment resynthesised from its features: [B, S] float."""
        from ..kernels import sample_loop as K
        from ..models import lpcnet as M

        cfg, b, dev = self.cfg, self._b, self.device
        with torch.no_grad():
            fused = M.fuse_inference_params(params, cfg)
            kw = (K.masked_kernel_weights(K.kernel_weights(fused, cfg, dtype=torch.float32))
                  if self.use_kernel else None)
            fst = M.init_frame_state(b, cfg, dev)
            sst = M.init_sample_state(b, cfg, dev)
            out = []
            for t in range(self._t):
                fst, _, ca, cb, lpc = M.frame_network(
                    fused, fst, self.features[:, t], cfg)
                if kw is None:
                    sst, pcm = M.synthesize_frame(fused, sst, ca, cb, lpc)
                else:
                    sst, pcm = K.synthesize_frame_kernel(
                        kw, sst, ca.contiguous(), cb.contiguous(),
                        lpc.contiguous())
                out.append(pcm)
            return torch.cat(out, dim=1).cpu().numpy()

    def _per_segment(self, params) -> List[Dict[str, float]]:
        from ..utils.quality import quality_metrics

        syn = self.synthesize(params)
        la = self.cfg.lookahead * FRAME
        orig = self._orig
        if la:
            orig, syn = orig[:, :-la], syn[:, la:]
        return [quality_metrics(orig[i], syn[i], self.device)
                for i in range(self._b)]

    def evaluate(self, params) -> Dict[str, float]:
        """Mean quality metrics over all held-out segments (lower
        band-LSD / MCD is better; higher fwSegSNR is better)."""
        per_seg = self._per_segment(params)
        return {k: float(np.mean([m[k] for m in per_seg]))
                for k in per_seg[0]}

    def evaluate_per_clip(self, params) -> List[Dict[str, float]]:
        """Per-clip means (for spotting clip-specific regressions)."""
        per_seg = self._per_segment(params)
        out = []
        for ci in range(max(self._clip_of_seg) + 1):
            ms = [m for m, c in zip(per_seg, self._clip_of_seg) if c == ci]
            out.append({k: float(np.mean([m[k] for m in ms]))
                        for k in ms[0]})
        return out


class BestTracker:
    """Best-checkpoint selection on a validation scalar (lower = better)."""

    def __init__(self, metric: str = "band_lsd_db"):
        self.metric = metric
        self.best: Optional[float] = None
        self.best_step: Optional[int] = None

    def update(self, step: int, metrics: Dict[str, float]) -> bool:
        v = metrics[self.metric]
        if self.best is None or v < self.best:
            self.best, self.best_step = v, step
            return True
        return False
