"""LPC math: Levinson-Durbin, cepstrum -> LPC, reflection coefficients
(src/freq.c:86-320, src/lpcnet.c:57-79), batched over leading dims."""

from __future__ import annotations

import torch

from .constants import FREQ_SIZE, LPC_ORDER, WINDOW_SIZE
from .spectrum import band_energy_from_cepstrum, interp_band_gain, inverse_transform


def levinson(ac: torch.Tensor):
    """Levinson-Durbin with the reference's 30 dB early exit.

    ac [..., 17] -> (lpc [..., 16], rc [..., 16], error [...]). Once the
    prediction error drops below .001*ac[0] (or ac[0] == 0, which leaves
    lpc = 0) the recursion stops; here every order runs and a `done` mask
    freezes the state, which gives the same results.
    """
    ac = ac.to(torch.float32)
    lpc = ac.new_zeros(ac.shape[:-1] + (LPC_ORDER,))
    rc = torch.zeros_like(lpc)
    error = ac[..., 0]
    ac0 = ac[..., 0]
    done = ac0 == 0.0
    for i in range(LPC_ORDER):
        if i > 0:
            rr = (lpc[..., :i] * torch.flip(ac[..., 1:i + 1], (-1,))).sum(-1) \
                + ac[..., i + 1]
        else:
            rr = ac[..., 1]
        r = -rr / torch.where(error == 0, 1.0, error)
        new_lpc = lpc.clone()
        if i > 0:
            new_lpc[..., :i] = lpc[..., :i] + r[..., None] * torch.flip(
                lpc[..., :i], (-1,))
        new_lpc[..., i] = r
        new_rc = rc.clone()
        new_rc[..., i] = r
        new_error = error * (1.0 - r * r)
        step_done = done | (new_error < 0.001 * ac0)
        lpc = torch.where(done[..., None], lpc, new_lpc)
        rc = torch.where(done[..., None], rc, new_rc)
        error = torch.where(done, error, new_error)
        done = step_done
    return lpc, rc, error


def lpc_from_bands(band_e: torch.Tensor):
    """Band energies -> LPC via spectral autocorrelation (src/freq.c:275-297)."""
    xr = interp_band_gain(band_e)
    xr[..., FREQ_SIZE - 1] = 0.0
    x_auto = inverse_transform(xr.to(torch.complex64))
    ac = x_auto[..., :LPC_ORDER + 1]
    # -40 dB noise floor + lag windowing
    ac0 = ac[..., 0] * (1.0 + 1e-4) + WINDOW_SIZE / 12.0 / 38.0
    lags = torch.arange(1, LPC_ORDER + 1, dtype=torch.float32, device=ac.device)
    ac_rest = ac[..., 1:] * (1.0 - 6e-5 * lags * lags)
    ac = torch.cat([ac0[..., None], ac_rest], dim=-1)
    lpc, _, err = levinson(ac)
    return lpc, err


def lpc_from_cepstrum(ceps: torch.Tensor) -> torch.Tensor:
    """18-dim cepstrum -> 16 LPC coefficients (src/freq.c:310-320)."""
    lpc, _ = lpc_from_bands(band_energy_from_cepstrum(ceps))
    return lpc


_WEIGHTS = {}


def lpc_weighting(lpc: torch.Tensor, gamma: float) -> torch.Tensor:
    """Bandwidth expansion: lpc[i] *= gamma^(i+1) (src/freq.c:299-308). The
    factors gamma^(i+1) are computed on `lpc`'s device once a (gamma,
    device) and kept, so a call uploads nothing and a CUDA graph may hold
    it."""
    key = (float(gamma), lpc.device)
    w = _WEIGHTS.get(key)
    if w is None:
        k = torch.arange(1, LPC_ORDER + 1, dtype=torch.float32,
                         device=lpc.device)
        w = _WEIGHTS[key] = torch.pow(torch.tensor(gamma, dtype=torch.float32,
                                                   device=lpc.device), k)
    return lpc * w


def rc2lpc(rc: torch.Tensor) -> torch.Tensor:
    """Reflection coefficients -> LPC by the step-up recursion
    a_i(j) = a_{i-1}(j) + k_i * a_{i-1}(i-j-1) (src/lpcnet.c:57-79)."""
    tmp = rc.to(torch.float32)
    idx = torch.arange(LPC_ORDER, device=tmp.device)
    for i in range(LPC_ORDER):
        rev = torch.clamp(i - idx - 1, 0, LPC_ORDER - 1)
        upd = tmp + tmp[..., i:i + 1] * tmp[..., rev]
        tmp = torch.where(idx <= i - 1, upd, tmp)
    return tmp
