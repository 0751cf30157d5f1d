"""The spectral pieces that LPC synthesis needs: cepstrum -> band energies
-> per-bin gains -> autocorrelation by inverse FFT (src/freq.c:202-318)."""

from __future__ import annotations

import torch

from .constants import BAND_INTERP, COMPENSATION, DCT_MATRIX, NB_BANDS, WINDOW_SIZE


def _const(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def inverse_transform(spec: torch.Tensor) -> torch.Tensor:
    """Real IDFT without 1/N of a half spectrum: N * irfft(spec)
    (src/freq.c:256-273)."""
    return torch.fft.irfft(spec, n=WINDOW_SIZE, dim=-1) * WINDOW_SIZE


def interp_band_gain(band_e: torch.Tensor) -> torch.Tensor:
    """[..., 18] band gains -> [..., 161] per-bin gains."""
    return torch.matmul(band_e, _const(BAND_INTERP, band_e).T)


def idct(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-III (inverse DCT-II) over the last axis."""
    return torch.matmul(x, _const(DCT_MATRIX, x).T)


def band_energy_from_cepstrum(ceps: torch.Tensor) -> torch.Tensor:
    """10^idct(ceps + 4 at DC) * compensation (src/freq.c:310-318)."""
    tmp = ceps[..., :NB_BANDS].to(torch.float32).clone()
    tmp[..., 0] += 4.0
    return torch.pow(10.0, idct(tmp)) * _const(COMPENSATION, tmp)
