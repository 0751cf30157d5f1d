"""Functional layers on dicts of tensors, in the JAX package's (Keras)
parameter layouts:

* dense:  {"kernel": [in, out], "bias": [out]}
* conv1d: {"kernel": [k, in, out], "bias": [out]}
* embedding: {"table": [vocab, dim]}
* reset-after GRU, gate order z, r, h: {"recurrent": [N, 3N], "bias": [2, 3N]}
* mdense (DualFC): {"kernel": [in, out, 2], "bias": [out, 2], "factor": [out, 2]}
* GRU with its input weights (the training graph): the reset-after GRU's
  keys plus {"kernel": [in, 3N]}, bias[0] the input bias

Matmuls are float32 (callers on CUDA disable TF32, see utils.device).

Activations come in two implementations: "exact" (torch.tanh/sigmoid, the
production path) and "cref", the reference C's table approximations
(src/vec.h:82-104), used only by the C golden-parity tests. The switch is a
module-level setting, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, Any]

_ACT_IMPL = "exact"
_TANSIG_TABLE = None
_TANSIG_ON = {}         # device -> (the host table it copies, the copy)


def _tansig_table(device) -> torch.Tensor:
    """The table on `device`, copied there once for each host table (no
    upload a call, so a CUDA graph may read it)."""
    # tansig_table.h holds tanh(.04*i) printed with 6 decimals
    global _TANSIG_TABLE
    if _TANSIG_TABLE is None:
        t = np.round(np.tanh(0.04 * np.arange(201, dtype=np.float64)), 6)
        _TANSIG_TABLE = torch.from_numpy(t.astype(np.float32))
    device = torch.device(device)
    host, table = _TANSIG_ON.get(device, (None, None))
    if host is not _TANSIG_TABLE:
        table = _TANSIG_TABLE.to(device)
        _TANSIG_ON[device] = (_TANSIG_TABLE, table)
    return table


def set_cref_tansig_table(tab) -> None:
    """Use the exact table of the compiled reference (3 of 201 entries differ
    by ~1e-6 from the recomputation)."""
    global _TANSIG_TABLE
    tab = np.asarray(tab, np.float32)
    if tab.shape != (201,):
        raise ValueError(f"tansig table must have 201 entries, got {tab.shape}")
    _TANSIG_TABLE = torch.from_numpy(tab.copy())


def tanh_cref(x: torch.Tensor) -> torch.Tensor:
    """tanh_approx (src/vec.h:82-99): 201-entry table + 2nd-order correction."""
    ax = x.abs()
    i = torch.clamp(torch.floor(0.5 + 25.0 * ax), max=200.0)
    ax = ax - 0.04 * i
    y = _tansig_table(x.device)[i.long()]
    dy = 1.0 - y * y
    y = y + ax * dy * (1.0 - y * ax)
    return torch.where(x < 0, -y, y)


def sigmoid_cref(x: torch.Tensor) -> torch.Tensor:
    """sigmoid_approx (src/vec.h:101-104)."""
    return 0.5 + 0.5 * tanh_cref(0.5 * x)


def set_activation_impl(name: str) -> None:
    """Switch tanh/sigmoid between 'exact' and 'cref' (test-only)."""
    global _ACT_IMPL
    if name not in ("exact", "cref"):
        raise ValueError(name)
    _ACT_IMPL = name


class activation_impl:
    """Context manager: `with activation_impl('cref'): ...`."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.prev = _ACT_IMPL
        set_activation_impl(self.name)

    def __exit__(self, *exc):
        set_activation_impl(self.prev)


def activation_key(device) -> tuple:
    """What an activation on `device` reads besides its input: the
    implementation in force and, under "cref", the table there (the same
    object while the table is unchanged). A CUDA graph of activations
    stays valid while this does."""
    return (_ACT_IMPL, _tansig_table(device) if _ACT_IMPL == "cref" else None)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return tanh_cref(x) if _ACT_IMPL == "cref" else torch.tanh(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return sigmoid_cref(x) if _ACT_IMPL == "cref" else torch.sigmoid(x)


def activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "linear":
        return x
    if activation == "tanh":
        return tanh(x)
    if activation == "sigmoid":
        return sigmoid(x)
    raise ValueError(f"unknown activation {activation}")


def dense(params: Params, x: torch.Tensor, activation: str = "linear"):
    return activate(torch.matmul(x, params["kernel"]) + params["bias"],
                    activation)


def embedding(params: Params, idx: torch.Tensor) -> torch.Tensor:
    """Row gather (the JAX package's one-hot matmul is a TPU workaround)."""
    return params["table"][idx.long()]


def conv1d_stream(params: Params, x: torch.Tensor, mem: torch.Tensor,
                  activation: str = "tanh"):
    """Single-step streaming conv1d as one matmul over the window.

    x [..., in], mem [..., k-1, in] (the C ring buffer, src/nnet.c:460-469).
    Returns (y [..., out], new_mem).
    """
    kernel = params["kernel"]
    k, cin, cout = kernel.shape
    window = torch.cat([mem, x[..., None, :]], dim=-2)        # [..., k, in]
    y = torch.matmul(window.reshape(window.shape[:-2] + (k * cin,)),
                     kernel.reshape(k * cin, cout)) + params["bias"]
    return activate(y, activation), window[..., 1:, :]


def _gru_gates(h, gate_in, zrec, activation):
    n = h.shape[-1]
    zr = sigmoid(gate_in[..., :2 * n] + zrec[..., :2 * n])
    z, r = zr[..., :n], zr[..., n:]
    hcand = activate(gate_in[..., 2 * n:] + r * zrec[..., 2 * n:], activation)
    return z * h + (1.0 - z) * hcand


def gru_step(params: Params, h: torch.Tensor, x: torch.Tensor,
             activation: str = "tanh"):
    """One reset-after GRU step with its input weights (compute_gru2,
    src/nnet.c:281-322): h [..., N] state, x [..., in] input."""
    gate_in = torch.matmul(x, params["kernel"]) + params["bias"][0]
    return gru_precomputed_step(params, h, gate_in, activation)


def gru_precomputed_step(params: Params, h: torch.Tensor,
                         gate_in: torch.Tensor, activation: str = "tanh"):
    """Reset-after GRU step whose input contribution (x@kernel + bias[0]) is
    precomputed in `gate_in` [..., 3N] (src/nnet.c:281-322)."""
    zrec = torch.matmul(h, params["recurrent"]) + params["bias"][1]
    return _gru_gates(h, gate_in, zrec, activation)


def mdense_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Dual-FC logits of every output row, without the final activation:
    factor0*tanh(w0.x+b0) + factor1*tanh(w1.x+b1) (src/nnet.c:186-211).

    x [..., in] -> [..., out]. The JAX package's mdense_logits_pair computes
    the one row a bit-tree step selects; here the sampler computes all rows
    once per step and gathers.
    """
    s = torch.einsum("...i,ioc->...oc", x, params["kernel"]) + params["bias"]
    return (params["factor"] * tanh(s)).sum(-1)


# --------------------------------------------------------------------------
# Sequence forms (the training graph)
# --------------------------------------------------------------------------

def repeat_frames(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [..., F, C] -> [..., F n, C], each frame repeated n times. An
    expand, not `repeat_interleave`: the backward then sums the n copies in
    a fixed order, where `repeat_interleave`'s index_add adds them with
    atomics on the card, in an order that changes from run to run."""
    *lead, f, c = x.shape
    return x[..., None, :].expand(*lead, f, n, c).reshape(*lead, f * n, c)


def conv1d_seq(params: Params, x: torch.Tensor, activation: str = "tanh",
               padding: str = "valid"):
    """Sequence conv1d over [..., T, in] -> [..., T', out], as one matmul
    over the unfolded windows. 'valid' (T' = T - k + 1) is the training
    graph's (training_tf2/lpcnet.py:243-245); 'causal' (T' = T) left-pads
    k - 1 zero frames, as the streaming C ring buffer started from zero
    (src/nnet.c:452-470)."""
    kernel = params["kernel"]                                  # [k, in, out]
    k, cin, cout = kernel.shape
    if padding == "causal":
        x = torch.cat([x.new_zeros(x.shape[:-2] + (k - 1, cin)), x], dim=-2)
    elif padding != "valid":
        raise ValueError(f"unknown padding {padding}")
    win = x.unfold(-2, k, 1)                                   # [..., T', in, k]
    win = win.transpose(-1, -2).reshape(win.shape[:-2] + (k * cin,))
    y = torch.matmul(win, kernel.reshape(k * cin, cout)) + params["bias"]
    return activate(y, activation)


def gru_seq(params: Params, x: torch.Tensor, h0: torch.Tensor | None = None,
            activation: str = "tanh"):
    """Reset-after GRU over a sequence [..., T, in] -> ([..., T, N], h_T),
    plain float32: the input product for the whole sequence is one matmul,
    the recurrence a step-by-step loop."""
    n = params["recurrent"].shape[0]
    gate_in = torch.matmul(x, params["kernel"]) + params["bias"][0]
    h = h0 if h0 is not None else x.new_zeros(x.shape[:-2] + (n,))
    hs = []
    for t in range(x.shape[-2]):
        h = gru_precomputed_step(params, h, gate_in[..., t, :], activation)
        hs.append(h)
    return torch.stack(hs, dim=-2), h


def mdense(params: Params, x: torch.Tensor, activation: str = "sigmoid"):
    """DualFC: two dense channels, tanh, per-channel factor, sum, activation
    (training_tf2/mdense.py:64-72, compute_mdense src/nnet.c:137-161)."""
    return activate(mdense_logits(params, x), activation)
