"""Public API: model loading and the batched vocoder.

    fused, cfg = load_model("model.npz", int8=True)       # on the GPU
    synth = Synthesizer(fused=fused, cfg=cfg, batch=256)
    pcm = synth.synthesize(features)                      # [256, 160] int16

Everything runs on CUDA unless `device="cpu"` is passed.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from .codec.decoder import LPCNetDecoder
from .dsp.constants import NB_TOTAL_FEATURES
from .models import lpcnet as M
from .nn.quantized import quantize_fused
from .utils.device import resolve_device
from .weights.checkpoint import load_checkpoint

# the shipped demo vocoder, read by path from the JAX package's data folder
DEMO_MODEL_PATH = str(Path(__file__).resolve().parent.parent / "lpcnet_tpu"
                      / "data" / "demo_model.npz")


def load_model(path: Optional[str] = None, seed: int = 0, int8: bool = False,
               device=None):
    """Load fused inference params: a `.npz` checkpoint, or (path=None) a
    random init from numpy's RandomState(seed). That init cannot reproduce
    the JAX package's `jax.random` weights for the same seed; to compare the
    two packages, carry JAX weights across with `weights.convert`.

    int8=True converts GRU-A's off-diagonal recurrent and GRU-B's matrices
    to int8 (the reference's DOT_PROD numerics); the kernel then runs its q8
    form. Returns (fused params on `device`, cfg).
    """
    dev = resolve_device(device)
    if path is None:
        cfg = M.LPCNetConfig()
        params = M.init_params(cfg, seed, dev)
    elif path.endswith(".npz"):
        params, cfg = load_checkpoint(path, dev)
    else:
        raise NotImplementedError(
            f"{path}: only .npz checkpoints load here; DNNw weight blobs are "
            "not ported yet")
    fused = M.fuse_inference_params(params, cfg)
    if int8:
        fused = quantize_fused(fused)
    return fused, cfg


class Synthesizer:
    """Batched vocoder: one feature frame per stream in, PCM out."""

    def __init__(self, model_path: Optional[str] = None, batch: int = 1,
                 fused=None, cfg: Optional[M.LPCNetConfig] = None,
                 device=None):
        dev = resolve_device(device)
        if fused is None:
            fused, cfg = load_model(model_path, device=dev)
        self.cfg = cfg or M.LPCNetConfig()
        self.batch = batch
        self._dec = LPCNetDecoder.from_fused(fused, self.cfg, batch,
                                             device=dev)

    def synthesize(self, features: np.ndarray) -> np.ndarray:
        """[B, 36] (or [B, >=20]) one frame of features -> [B, 160] int16."""
        feats = np.zeros((self.batch, NB_TOTAL_FEATURES), np.float32)
        feats[:, :features.shape[-1]] = features
        return self._dec.synthesize(feats)

    def reset(self):
        self._dec.reset()
