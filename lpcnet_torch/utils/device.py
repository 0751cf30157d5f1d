"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Entry-point device: CUDA unless the caller asks for something else.

    Raises when CUDA is requested (explicitly or by default) but missing:
    an entry point never falls back to the host on its own. On CUDA the
    float32 matmul and cuDNN paths are pinned to full float32 (no TF32),
    matching the JAX package's HIGHEST-precision frame network.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lpcnet_torch: CUDA is not available; pass device='cpu' to "
                "run the plain PyTorch path on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
