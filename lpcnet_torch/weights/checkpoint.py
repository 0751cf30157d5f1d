"""The npz checkpoint format shared with the JAX package: '/'-joined
parameter paths -> arrays, plus the model config as JSON bytes under
`__config__`."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import numpy as np

from ..models.lpcnet import LPCNetConfig
from .convert import params_to_torch


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of tensors or arrays -> {'a/b': numpy array}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = (tree.detach().cpu().numpy()
                            if hasattr(tree, "detach") else np.asarray(tree))
    return out


def save_checkpoint(path: str, params: Any, cfg: LPCNetConfig | None = None) -> None:
    meta = json.dumps(dataclasses.asdict(cfg)) if cfg is not None else "{}"
    np.savez(path, __config__=np.frombuffer(meta.encode(), np.uint8),
             **flatten_tree(params))


def load_checkpoint(path: str, device="cpu"):
    """npz -> (nested dict of tensors on `device`, LPCNetConfig)."""
    with np.load(path) as d:
        raw = d["__config__"].tobytes().decode() if "__config__" in d else "{}"
        flat = {k: d[k] for k in d.files if k != "__config__"}
    cfg_dict = json.loads(raw)
    cfg = LPCNetConfig(**cfg_dict) if cfg_dict else LPCNetConfig()
    return params_to_torch(flat, device), cfg
