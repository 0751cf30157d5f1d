"""Carry weights and states from the JAX package's layouts into the port.

Everything here reads plain arrays through `numpy.asarray`, so it accepts
numpy arrays and any array type that converts to numpy (JAX arrays do)
without importing JAX. Layouts and key names stay those of the JAX package:
nested dicts keyed like `models/lpcnet.py`, or the flat '/'-joined keys of
its npz checkpoints.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def array_to_torch(a, device="cpu", dtype: torch.dtype | None = None
                   ) -> torch.Tensor:
    """One array -> tensor. Integer arrays (the q8 weights) keep their type;
    bfloat16 arrays (ml_dtypes, which numpy cannot hand to torch) come
    across bit for bit; uint32 (KISS99 words) widens to int64. `dtype`
    recasts floating arrays only."""
    a = np.array(a)            # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    elif a.dtype == np.uint32:
        t = torch.from_numpy(a.astype(np.int64))
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_to_torch(tree: Any, device="cpu", dtype: torch.dtype | None = None
                    ) -> Dict[str, Any]:
    """JAX params, fused params (float or q8) or a kernel bundle, as a nested
    dict or as flat '/'-joined keys -> the same nested dict of tensors."""
    if isinstance(tree, dict) and any("/" in k for k in tree):
        nested: Dict[str, Any] = {}
        for key, val in tree.items():
            d = nested
            *parents, leaf = key.split("/")
            for p in parents:
                d = d.setdefault(p, {})
            d[leaf] = val
        tree = nested
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device, dtype) for k, v in tree.items()}
    return array_to_torch(tree, device, dtype)


def tree_to(tree: Any, device) -> Any:
    """Move a nested dict of tensors to `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def sample_state_to_torch(state, device="cpu"):
    """A JAX SampleState (fields gru_a, gru_b, last_sig, last_exc, deemph,
    rng=(z, w, jsr, jcong)) -> the port's SampleState."""
    from ..models.lpcnet import SampleState
    from ..utils.rng import Kiss99State
    t = lambda a: array_to_torch(a, device)
    return SampleState(t(state.gru_a), t(state.gru_b), t(state.last_sig),
                       t(state.last_exc).to(torch.int32), t(state.deemph),
                       Kiss99State(*(t(x) for x in state.rng)))


def sample_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The port's SampleState -> numpy arrays in the JAX layout (KISS99
    words as uint32)."""
    n = lambda x: x.detach().cpu().numpy()
    out = {f: n(getattr(state, f))
           for f in ("gru_a", "gru_b", "last_sig", "last_exc", "deemph")}
    for f, x in zip(("z", "w", "jsr", "jcong"), state.rng):
        out[f] = n(x).astype(np.uint32)
    return out
