"""Cepstral VQ codebooks of the 1.6 kb/s codec: loading and saving.

The reference ships its codebooks as generated C arrays (ceps_codebooks.c).
Here they are an .npz with keys ceps_codebook1/2/3 ([1024, 17], the three
stages of the endpoint frame's cepstrum 1..17) and ceps_codebook_diff4
([4096, 18], the signed multi-predictor codebook of the mid frame). The
shipped set is read by path from the JAX package's data folder. Training
new codebooks (`train_codebooks` in the JAX package) is not ported.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

DEFAULT_PATH = str(Path(__file__).resolve().parents[2] / "lpcnet_tpu"
                   / "data" / "codebooks.npz")


class Codebooks(NamedTuple):
    stage1: torch.Tensor   # [1024, 17]
    stage2: torch.Tensor   # [1024, 17]
    stage3: torch.Tensor   # [1024, 17]
    diff4: torch.Tensor    # [4096, 18]


def load_codebooks(path: str | None = None, device="cpu") -> Codebooks:
    d = np.load(path or DEFAULT_PATH)
    t = lambda k: torch.as_tensor(d[k], dtype=torch.float32, device=device)
    return Codebooks(t("ceps_codebook1"), t("ceps_codebook2"),
                     t("ceps_codebook3"), t("ceps_codebook_diff4"))


def save_codebooks(path: str, cb: Codebooks) -> None:
    n = lambda x: x.detach().cpu().numpy()
    np.savez(path, ceps_codebook1=n(cb.stage1), ceps_codebook2=n(cb.stage2),
             ceps_codebook3=n(cb.stage3), ceps_codebook_diff4=n(cb.diff4))
