"""Carry weights and states between the JAX package's layouts and the port.

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


def _fields_to_torch(state, cls, nested, device):
    """A NamedTuple of the JAX package, field by field -> `cls`; `nested`
    maps the fields that are NamedTuples themselves to their converters."""
    return cls(*(nested[f](getattr(state, f), device) if f in nested
                 else array_to_torch(getattr(state, f), device)
                 for f in cls._fields))


def encoder_state_to_torch(state, device="cpu"):
    """A JAX EncoderState -> the port's (`codec.features`)."""
    from ..codec.features import EncoderState
    from ..dsp.pitch import ViterbiCarry
    vit = lambda v, dev: _fields_to_torch(v, ViterbiCarry, {}, dev)
    return _fields_to_torch(state, EncoderState, {"viterbi": vit}, device)


def plc_state_to_torch(state, device="cpu"):
    """A JAX BatchedPLCState (`lpcnet_tpu/plc/batched.py`) -> the port's,
    every leaf: frame and sample state, conditioning, rings, analysis state,
    PLC-net states, queues and counters."""
    from ..models.lpcnet import FrameState
    from ..models.plc import PLCNetState
    from ..plc.batched import BatchedPLCState
    plain = lambda cls: (lambda v, dev: _fields_to_torch(v, cls, {}, dev))
    return _fields_to_torch(state, BatchedPLCState, {
        "fstate": plain(FrameState), "sstate": sample_state_to_torch,
        "enc": encoder_state_to_torch, "plc_net": plain(PLCNetState),
        "plc_ring": plain(PLCNetState)}, device)


def host_plc_state_to_torch(src, dst) -> None:
    """The state of a JAX host PLC (`lpcnet_tpu/plc/plc.py::PLC`, or any
    object with its fields) into the port's `plc.plc.PLC` `dst`, in place:
    the core's frame and sample state, conditioning and deferred feature
    buffer; the encoder and PLC-net states and the ring of PLC-net copies;
    the PLC's own buffers, counters, DC trackers and FEC queue."""
    from ..models.lpcnet import FrameState
    from ..models.plc import PLCNetState
    dev = dst.device
    plain = lambda cls, v: _fields_to_torch(v, cls, {}, dev)
    c, d = src.core, dst.core
    d.fstate = plain(FrameState, c.fstate)
    d.sstate = sample_state_to_torch(c.sstate, dev)
    d.cond_a, d.cond_b, d.lpc = (array_to_torch(x, dev)
                                 for x in (c.cond_a, c.cond_b, c.lpc))
    d.feature_buffer = [np.array(f, np.float32) for f in c.feature_buffer]
    dst.enc = encoder_state_to_torch(src.enc, dev)
    dst.plc_net = plain(PLCNetState, src.plc_net)
    dst.plc_copy = [plain(PLCNetState, x) for x in src.plc_copy]
    for f in ("pcm", "features", "dc_mem", "syn_dc", "dc_buf",
              "queued_samples"):
        setattr(dst, f, np.array(getattr(src, f)))
    for f in ("pcm_fill", "skip_analysis", "blend", "loss_count",
              "queued_update", "fec_keep_pos", "fec_read_pos", "fec_skip"):
        setattr(dst, f, getattr(src, f))
    dst.fec = [np.array(x) for x in src.fec]


def state_to_numpy(state) -> Any:
    """Any of the port's states (nested NamedTuples of tensors) -> nested
    dicts of numpy arrays keyed by field name, KISS99 words as uint32: what
    the JAX package's NamedTuples of the same names are built from."""
    from ..utils.rng import Kiss99State
    if isinstance(state, Kiss99State):
        return {f: x.detach().cpu().numpy().astype(np.uint32)
                for f, x in zip(state._fields, state)}
    if isinstance(state, tuple):
        return {f: state_to_numpy(x) for f, x in zip(state._fields, state)}
    return state.detach().cpu().numpy()


def train_params_to_torch(tree: Any, device="cpu") -> Dict[str, Any]:
    """Training parameters (the JAX package's nested dict or flat
    '/'-joined keys, as numpy-convertible arrays) -> the port's nested dict
    of float32 leaf tensors with `requires_grad`."""
    def leafify(t):
        if isinstance(t, dict):
            return {k: leafify(v) for k, v in t.items()}
        return t.detach().clone().requires_grad_(True)
    return leafify(params_to_torch(tree, device, torch.float32))


def _flat_numpy(tree: Any, pick, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_numpy(v, pick, f"{prefix}{k}/"))
    else:
        val = pick(tree)
        if val is not None:
            out[prefix[:-1]] = val.detach().cpu().numpy().copy()
    return out


def params_to_numpy(params: Any) -> Dict[str, np.ndarray]:
    """The port's parameters -> a flat dict of numpy arrays (copies) under
    the JAX package's leaf names ('gru_a/kernel', ...)."""
    return _flat_numpy(params, lambda t: t)


def grads_to_numpy(params: Any) -> Dict[str, np.ndarray]:
    """The gradients (`.grad`) of the port's parameters, flat like
    `params_to_numpy`; leaves without a gradient are left out."""
    return _flat_numpy(params, lambda t: t.grad)
