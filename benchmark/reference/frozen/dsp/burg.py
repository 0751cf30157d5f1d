# Frozen copy of lpcnet_torch/dsp/burg.py at commit d7e6271, kept to its plain
# paths. Part of the benchmark's yardstick: not to be edited.
"""Burg LPC analysis (SILK float variant) and the Burg cepstrum features.

The reference implements silk_burg_analysis in double precision
(src/burg.c:98-245) and wraps it into two half-frame "Burg cepstra", the
side features of the PLC network (src/freq.c:156-199).

* `burg_analysis_np`: float64 numpy, faithful to the C code; the oracle.
* `burg_cepstral_analysis`: the batched float32 torch version of the whole
  feature computation, for the device.
"""

from __future__ import annotations

import torch

from .constants import FRAME_SIZE, LPC_ORDER, PREEMPHASIS, WINDOW_SIZE
from .spectrum import (compute_band_energy_inverse, dct, forward_transform,
                       log_band_energy)

FIND_LPC_COND_FAC = 1e-5


def burg_half_frame(x: torch.Tensor, order: int = LPC_ORDER,
                    min_inv_gain: float = 1e-3):
    """The same recursion in float32 over a batch: x [B, n] -> (A [B, order],
    residual energy [B]). All `order` iterations run; a stream that reached
    the maximum gain keeps its state under a `done` mask, which replaces the
    C's early exit. The iteration index is a Python int, so the reference's
    index arithmetic becomes slices and flips."""
    x = x.to(torch.float32)
    ns = x.shape[-1]
    D = order
    rev = lambda v: torch.flip(v, (-1,))
    C0 = (x * x).sum(-1)
    C_first = torch.stack([(x[:, :ns - n] * x[:, n:]).sum(-1)
                           for n in range(1, D + 1)], dim=-1)
    C_last = C_first.clone()
    CAf = x.new_zeros(x.shape[0], D + 1)
    CAf[:, 0] = C0 * (1 + FIND_LPC_COND_FAC) + 1e-9
    CAb = CAf.clone()
    Af = x.new_zeros(x.shape[0], D)
    inv_gain = torch.ones_like(C0)
    done = torch.zeros_like(C0, dtype=torch.bool)

    for n in range(D):
        xn, xl = x[:, n], x[:, ns - n - 1]
        x_fwd = rev(x[:, :n])                    # x[n-k-1], k < n
        x_bwd = x[:, ns - n:ns]                  # x[ns-n+k], k < n
        a = Af[:, :n]
        tmp1 = xn + (x_fwd * a).sum(-1)
        tmp2 = xl + (x_bwd * a).sum(-1)
        C_first_n, C_last_n = C_first.clone(), C_last.clone()
        C_first_n[:, :n] -= xn[:, None] * x_fwd
        C_last_n[:, :n] -= xl[:, None] * x_bwd
        CAf_n, CAb_n = CAf.clone(), CAb.clone()
        CAf_n[:, :n + 1] -= tmp1[:, None] * rev(x[:, :n + 1])
        CAb_n[:, :n + 1] -= tmp2[:, None] * x[:, ns - n - 1:ns]
        t1 = C_first_n[:, n] + (rev(C_last_n[:, :n]) * a).sum(-1)
        t2 = C_last_n[:, n] + (rev(C_first_n[:, :n]) * a).sum(-1)
        CAf_n[:, n + 1] = t1
        CAb_n[:, n + 1] = t2

        num = t2 + (rev(CAb_n[:, 1:n + 1]) * a).sum(-1)
        nrg_b = CAb_n[:, 0] + (CAb_n[:, 1:n + 1] * a).sum(-1)
        nrg_f = CAf_n[:, 0] + (CAf_n[:, 1:n + 1] * a).sum(-1)
        rc = -2.0 * num / (nrg_f + nrg_b)

        gain_next = inv_gain * (1.0 - rc * rc)
        hit = gain_next <= min_inv_gain
        rc_cl = torch.sqrt(torch.clamp(1.0 - min_inv_gain / inv_gain, min=0.0))
        rc = torch.where(hit, torch.where(num > 0, -rc_cl, rc_cl), rc)
        inv_gain_n = torch.where(hit, torch.full_like(gain_next, min_inv_gain),
                                 gain_next)

        Af_n = Af.clone()
        Af_n[:, :n] = a + rc[:, None] * rev(a)
        Af_n[:, n] = rc
        CAf_u, CAb_u = CAf_n.clone(), CAb_n.clone()
        CAf_u[:, :n + 2] = CAf_n[:, :n + 2] + rc[:, None] * rev(CAb_n[:, :n + 2])
        CAb_u[:, :n + 2] = CAb_n[:, :n + 2] + rc[:, None] * rev(CAf_n[:, :n + 2])

        d1, dh = done[:, None], (done | hit)[:, None]
        C_first = torch.where(d1, C_first, C_first_n)
        C_last = torch.where(d1, C_last, C_last_n)
        CAf = torch.where(dh, torch.where(d1, CAf, CAf_n), CAf_u)
        CAb = torch.where(dh, torch.where(d1, CAb, CAb_n), CAb_u)
        Af = torch.where(d1, Af, Af_n)
        inv_gain = torch.where(done, inv_gain, inv_gain_n)
        done = done | hit

    nrg_plain = (CAf[:, 0] + (CAf[:, 1:] * Af).sum(-1)
                 - FIND_LPC_COND_FAC * C0 * (1.0 + (Af * Af).sum(-1)))
    nrg_gain = (C0 - (x[:, :D] * x[:, :D]).sum(-1)) * inv_gain
    return -Af, torch.where(done, nrg_gain, nrg_plain)


def _burg_cepstrum_half(pcm: torch.Tensor) -> torch.Tensor:
    """[..., 80] raw pcm -> [..., 18] Burg cepstrum (src/freq.c:156-186)."""
    n = pcm.shape[-1]
    lead = pcm.shape[:-1]
    burg_in = pcm[..., 1:] - PREEMPHASIS * pcm[..., :-1]
    A, g = burg_half_frame(burg_in.reshape(-1, n - 1))
    A = A.reshape(lead + (LPC_ORDER,))
    g = g.reshape(lead) / (n - 2 * (LPC_ORDER - 1))
    decay = torch.pow(torch.tensor(0.995, dtype=torch.float32,
                                   device=pcm.device),
                      torch.arange(1, LPC_ORDER + 1, dtype=torch.float32,
                                   device=pcm.device))
    x = pcm.new_zeros(lead + (WINDOW_SIZE,), dtype=torch.float32)
    x[..., 0] = 1.0
    x[..., 1:LPC_ORDER + 1] = -A * decay
    e_burg = compute_band_energy_inverse(forward_transform(x))
    e_burg = e_burg * (0.45 * g[..., None] / float(WINDOW_SIZE) ** 3)
    ceps = dct(log_band_energy(e_burg))
    ceps[..., 0] -= 4.0
    return ceps


def burg_cepstral_analysis(pcm: torch.Tensor) -> torch.Tensor:
    """[..., 160] frame -> [..., 36] sum and difference of the two
    half-frame Burg cepstra (src/freq.c:188-199). Both halves go through one
    batched recursion."""
    half = FRAME_SIZE // 2
    both = torch.stack([pcm[..., :half], pcm[..., half:]], dim=0)
    c = _burg_cepstrum_half(both.to(torch.float32))
    return torch.cat([0.5 * (c[0] + c[1]), c[0] - c[1]], dim=-1)
