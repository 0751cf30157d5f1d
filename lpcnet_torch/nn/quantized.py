"""Int8 inference ops: the reference's DOT_PROD numerics (src/vec.h:206-236).

    out = bias + (W_q @ x_q) / (128 * 127)

with W_q = round(128*w) int8 and x_q = floor(0.5 + 127*x) int8, accumulated
exactly in int32. PyTorch's CPU int8 matmul returns int8 and overflows, so
`qmatmul` widens both operands to int32 first.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .layers import _gru_gates

SCALE_1 = 1.0 / (128.0 * 127.0)


def quantize_weights_int8(w: torch.Tensor) -> torch.Tensor:
    """round(128*w) -> int8 (round half to even, as jnp.round)."""
    return torch.clamp(torch.round(w * 128.0), -128, 127).to(torch.int8)


def quantize_act_int8(x: torch.Tensor) -> torch.Tensor:
    """floor(0.5 + 127*x), the C's round-half-up (src/vec.h:243)."""
    return torch.clamp(torch.floor(0.5 + 127.0 * x), -128, 127).to(torch.int8)


def qmatmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> exact int32 sum, rescaled to float by SCALE_1.

    CUDA has no int32 matmul; there the sum runs in float64, whose 53-bit
    mantissa holds every such sum exactly.
    """
    if x_q.is_cuda:
        acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64))
    else:
        acc = torch.matmul(x_q.to(torch.int32), w_q.to(torch.int32))
    return acc.to(torch.float32) * SCALE_1


def gru_precomputed_step_q8(params: Dict[str, Any], h, gate_in,
                            activation: str = "tanh"):
    """Quantized GRU-A step: int8 off-diagonal recurrent on quantized h plus
    the float diagonal (src/nnet.c:410-448)."""
    zrec = (qmatmul(quantize_act_int8(h), params["recurrent_q8"])
            + params["recurrent_diag"] * torch.cat([h, h, h], -1)
            + params["bias"][1])
    return _gru_gates(h, gate_in, zrec, activation)


def gru_precomputed_step_q8_dense(params: Dict[str, Any], h, gate_in,
                                  activation: str = "tanh"):
    """Quantized GRU-B step: the full recurrent matrix in int8
    (compute_gruB, src/nnet.c:326-373)."""
    zrec = qmatmul(quantize_act_int8(h), params["recurrent_q8"]) \
        + params["bias"][1]
    return _gru_gates(h, gate_in, zrec, activation)


def split_diag(recurrent: torch.Tensor):
    """[N, 3N] recurrent kernel -> (off-diagonal part, per-gate diagonal [3N])."""
    n = recurrent.shape[0]
    eye = torch.eye(n, dtype=recurrent.dtype, device=recurrent.device)
    blocks = [recurrent[:, k * n:(k + 1) * n] for k in range(3)]
    off = torch.cat([b * (1 - eye) for b in blocks], dim=1)
    return off, torch.cat([torch.diagonal(b) for b in blocks])


def quantize_fused(fused: Dict[str, Any]) -> Dict[str, Any]:
    """Fused float params -> int8 inference form: GRU-A's off-diagonal
    recurrent, GRU-B's input and recurrent kernels become int8; the GRU-A
    diagonal stays float, as in the reference's sparse format."""
    fused = dict(fused)
    off, diag = split_diag(fused["gru_a_rec"]["recurrent"])
    gru_a = {k: v for k, v in fused["gru_a_rec"].items() if k != "recurrent"}
    fused["gru_a_rec"] = dict(gru_a, recurrent_q8=quantize_weights_int8(off),
                              recurrent_diag=diag.to(torch.float32))
    fused["gru_b_in_q8"] = quantize_weights_int8(fused.pop("gru_b_in"))
    gru_b = {k: v for k, v in fused["gru_b_rec"].items() if k != "recurrent"}
    fused["gru_b_rec"] = dict(gru_b, recurrent_q8=quantize_weights_int8(
        fused["gru_b_rec"]["recurrent"]))
    return fused


def is_quantized(fused: Dict[str, Any]) -> bool:
    return "gru_b_in_q8" in fused
