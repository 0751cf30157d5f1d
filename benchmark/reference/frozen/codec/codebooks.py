# Frozen copy of lpcnet_torch/codec/codebooks.py at commit d7e6271, kept to its plain
# paths. Part of the benchmark's yardstick: not to be edited.
"""The codec's cepstral VQ codebooks, read from their .npz file."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Codebooks(NamedTuple):
    stage1: torch.Tensor   # [1024, 17]
    stage2: torch.Tensor   # [1024, 17]
    stage3: torch.Tensor   # [1024, 17]
    diff4: torch.Tensor    # [4096, 18]


def load_codebooks(path: str, device="cpu") -> Codebooks:
    d = np.load(path)
    t = lambda k: torch.as_tensor(d[k], dtype=torch.float32, device=device)
    return Codebooks(t("ceps_codebook1"), t("ceps_codebook2"),
                     t("ceps_codebook3"), t("ceps_codebook_diff4"))
