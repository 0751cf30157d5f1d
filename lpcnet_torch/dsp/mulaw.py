"""u-law companding (255 levels, bias 128; src/common.h:37-58), exact log."""

from __future__ import annotations

import torch

LOG256 = 5.5451774445
_SCALE = 255.0 / 32768.0
_SCALE_1 = 32768.0 / 255.0


def ulaw2lin(u: torch.Tensor) -> torch.Tensor:
    """u-law code in [0, 255] (int or float) -> linear float32."""
    u = u.to(torch.float32) - 128.0
    s = torch.where(u >= 0, 1.0, -1.0)
    return s * _SCALE_1 * (torch.exp(u.abs() / 128.0 * LOG256) - 1.0)


def lin2ulaw(x: torch.Tensor) -> torch.Tensor:
    """Linear float -> u-law code in [0, 255], int32 (exact log2)."""
    x = x.to(torch.float32)
    s = torch.where(x >= 0, 1.0, -1.0)
    logv = 0.69315 * torch.log2(1.0 + _SCALE * x.abs())
    u = torch.clamp(128.0 + s * (128.0 * logv / LOG256), 0.0, 255.0)
    return torch.floor(0.5 + u).to(torch.int32)
