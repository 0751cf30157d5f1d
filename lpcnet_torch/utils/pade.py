"""Pade approximant fitting for cheap activation functions.

Counterpart of `lpcnet_tpu/utils/pade.py`, after the reference's offline
optimizer (training_tf2/pade.py): fits an odd [m/n] rational approximation
to tanh (or any odd function) over an interval, for quantized or embedded
deployments where transcendentals are expensive. An offline tool, not a
runtime path. Float64 tensors on `device` (the card unless the caller passes
`device="cpu"`), solved by `torch.linalg.lstsq`.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .device import resolve_device


def fit_pade_odd(fn: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
                 num_order: int = 5, den_order: int = 4,
                 x_max: float = 8.0, n_points: int = 2001, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares fit of an odd rational p(x)/q(x) to `fn` on
    [-x_max, x_max].

    p has odd powers up to num_order, q has even powers up to den_order with
    q(0) = 1. Returns (p coefficients, ascending odd powers; q coefficients,
    ascending even powers including the leading 1), float64 on `device`.
    """
    dev = resolve_device(device)
    x = torch.linspace(-x_max, x_max, n_points, dtype=torch.float64,
                       device=dev)
    y = fn(x)
    p_pows = torch.arange(1, num_order + 1, 2, dtype=torch.float64,
                          device=dev)
    q_pows = torch.arange(2, den_order + 1, 2, dtype=torch.float64,
                          device=dev)
    # linearized least squares: p(x) - y q'(x) = y, where q = 1 + q'
    a = torch.cat([x[:, None] ** p_pows, -y[:, None] * x[:, None] ** q_pows],
                  dim=1)
    # gelsd (the SVD solver numpy's lstsq uses) exists only on the CPU;
    # CUDA's lstsq is gels, a QR solve of the same full-rank system
    driver = "gelsd" if dev.type == "cpu" else None
    coef = torch.linalg.lstsq(a, y[:, None], driver=driver).solution[:, 0]
    n_p = p_pows.shape[0]
    q = torch.cat([torch.ones(1, dtype=torch.float64, device=dev),
                   coef[n_p:]])
    return coef[:n_p], q


def eval_pade_odd(x: torch.Tensor, p: torch.Tensor, q: torch.Tensor
                  ) -> torch.Tensor:
    """p(x) / q(x) in float64."""
    x = torch.as_tensor(x, dtype=torch.float64, device=p.device)
    x2 = x * x
    num = torch.zeros_like(x)
    for i, c in enumerate(p):
        num = num + c * x * x2 ** i
    den = torch.zeros_like(x)
    for i, c in enumerate(q):
        den = den + c * x2 ** i
    return num / den


def tanh_pade_error(num_order: int = 5, den_order: int = 4,
                    x_max: float = 8.0, device=None) -> float:
    """Max abs error of the fitted tanh approximation (diagnostic)."""
    p, q = fit_pade_odd(torch.tanh, num_order, den_order, x_max,
                        device=device)
    x = torch.linspace(-x_max, x_max, 10001, dtype=torch.float64,
                       device=p.device)
    return float(torch.max(torch.abs(eval_pade_odd(x, p, q)
                                     - torch.tanh(x))))
