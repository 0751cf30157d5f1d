"""Full-state training checkpoints (parameters, optimizer moments, step, the
truncated-BPTT carry, the EMA) for exact resume.

Counterpart of `lpcnet_tpu/train/checkpointing.py`, which stores flat leaf
lists through Orbax. Here a checkpoint is one `.npz` file in the layout of
`weights/checkpoint.py`: the parameters sit at the root under their
'/'-joined paths with the model config under `__config__`, so
`api.load_model` of either package loads the file as a model; everything
else of the training state sits under `__train__/`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

_PARAMS = "train_state/params/"
_EXTRA = "__train__/"


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = (tree.detach().cpu().numpy()
                            if isinstance(tree, torch.Tensor)
                            else np.asarray(tree))


def _key(path: str) -> str:
    return path[len(_PARAMS):] if path.startswith(_PARAMS) else _EXTRA + path


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_train_state(path: str, state: Any, cfg=None) -> None:
    """Save a training state (`Trainer.full_state()`, or any nesting of
    dicts, tuples, tensors and numbers) to `path` (.npz), atomically. The
    leaves under `train_state/params` go to the root of the file."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(state, "", flat)
    meta = json.dumps(dataclasses.asdict(cfg)) if cfg is not None else "{}"
    path = _npz(path)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, __config__=np.frombuffer(meta.encode(), np.uint8),
             **{_key(k): v for k, v in flat.items()})
    os.replace(tmp, path)


def _from_file(flat: Dict[str, np.ndarray], prefix: str, device) -> Any:
    """Rebuild what the file holds under `prefix` when the template has
    nothing there: tuples for digit keys, dicts otherwise."""
    if prefix[:-1] in flat:
        return torch.from_numpy(np.array(flat[prefix[:-1]])).to(device)
    heads = []
    for k in flat:
        if k.startswith(prefix):
            h = k[len(prefix):].split("/")[0]
            if h not in heads:
                heads.append(h)
    if not heads:
        return None
    if all(h.isdigit() for h in heads):
        return tuple(_from_file(flat, f"{prefix}{h}/", device)
                     for h in sorted(heads, key=int))
    return {h: _from_file(flat, f"{prefix}{h}/", device) for h in heads}


def _restore(like: Any, prefix: str, flat: Dict[str, np.ndarray], device):
    if like is None:
        return _from_file(flat, prefix, device)
    if isinstance(like, dict):
        return {k: _restore(v, f"{prefix}{k}/", flat, device)
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_restore(v, f"{prefix}{i}/", flat, device)
                          for i, v in enumerate(like))
    path = prefix[:-1]
    if path not in flat:
        raise KeyError(f"checkpoint has no leaf '{path}'")
    val = flat[path]
    if isinstance(like, torch.Tensor):
        if tuple(val.shape) != tuple(like.shape):
            raise ValueError(f"'{path}': checkpoint shape {val.shape}, "
                             f"expected {tuple(like.shape)}")
        return torch.from_numpy(np.array(val)).to(like.device, like.dtype)
    return type(like)(val)


def restore_train_state(path: str, like: Any) -> Any:
    """Restore a state saved by `save_train_state`; `like` gives the
    structure, devices and types (e.g. the `full_state()` of a freshly
    built trainer of the same config). Where `like` holds None (a carry that
    does not exist before the first step) the file's content is rebuilt."""
    with np.load(_npz(path)) as d:
        raw = {k: d[k] for k in d.files if k != "__config__"}
    flat = {}
    for k, v in raw.items():
        flat[k[len(_EXTRA):] if k.startswith(_EXTRA) else _PARAMS + k] = v
    leaves = [x for x in _leaves(like) if isinstance(x, torch.Tensor)]
    device = leaves[0].device if leaves else "cpu"
    return _restore(like, "", flat, device)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def latest_checkpoint(directory: str, prefix: str = "step_") -> Optional[str]:
    """The checkpoint `<prefix><number>[.npz]` with the largest number."""
    if not os.path.isdir(directory):
        return None
    best, best_n = None, -1
    for d in os.listdir(directory):
        stem = d[:-4] if d.endswith(".npz") else d
        if stem.startswith(prefix) and stem[len(prefix):].isdigit():
            if int(stem[len(prefix):]) > best_n:
                best, best_n = d, int(stem[len(prefix):])
    return os.path.join(directory, best) if best else None
