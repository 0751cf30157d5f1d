"""Spectral analysis and synthesis pieces: windowed FFT, band energies,
cepstrum (src/freq.c:131-273, src/lpcnet_enc.c:488-522), and the way back
from a cepstrum to per-bin gains and an autocorrelation (src/freq.c:202-318).

All functions take any leading batch dimensions. The band maps are small
dense float32 matmuls over precomputed matrices."""

from __future__ import annotations

import torch

from .constants import (BAND_ENERGY_MATRIX, BAND_INTERP, COMPENSATION,
                        DCT_MATRIX, FULL_WINDOW, NB_BANDS, WINDOW_SIZE)


_CONSTS = {}


def _const(a, like: torch.Tensor) -> torch.Tensor:
    """The constant array `a` as float32 on `like`'s device, made there
    once and kept: no upload a call, so a CUDA graph may read it. The cache
    holds `a` too, so its id stays unique."""
    key = (id(a), like.device)
    hit = _CONSTS.get(key)
    if hit is None:
        hit = _CONSTS[key] = (a, torch.as_tensor(a, dtype=torch.float32,
                                                 device=like.device))
    return hit[1]


def forward_transform(x: torch.Tensor) -> torch.Tensor:
    """rfft of a 320-sample window scaled by 1/WINDOW_SIZE, as the
    reference's KISS FFT forward pass (src/freq.c:242-254)."""
    return torch.fft.rfft(x.to(torch.float32), n=WINDOW_SIZE, dim=-1) / WINDOW_SIZE


def inverse_transform(spec: torch.Tensor) -> torch.Tensor:
    """Real IDFT without 1/N of a half spectrum: N * irfft(spec)
    (src/freq.c:256-273)."""
    return torch.fft.irfft(spec, n=WINDOW_SIZE, dim=-1) * WINDOW_SIZE


def apply_window(x: torch.Tensor) -> torch.Tensor:
    """Vorbis power-complementary window over the full 320 samples."""
    x = x.to(torch.float32)
    return x * _const(FULL_WINDOW, x)


def _power(spec: torch.Tensor) -> torch.Tensor:
    return spec.real * spec.real + spec.imag * spec.imag


def compute_band_energy(spec: torch.Tensor) -> torch.Tensor:
    """[..., 161] complex spectrum -> [..., 18] triangular band energies."""
    p = _power(spec)
    return torch.matmul(p, _const(BAND_ENERGY_MATRIX, p))


def compute_band_energy_inverse(spec: torch.Tensor) -> torch.Tensor:
    """Band-weighted sum of 1/|X|^2 (the Burg cepstrum; src/freq.c:60-84)."""
    inv = 1.0 / (_power(spec) + 1e-9)
    return torch.matmul(inv, _const(BAND_ENERGY_MATRIX, inv))


def interp_band_gain(band_e: torch.Tensor) -> torch.Tensor:
    """[..., 18] band gains -> [..., 161] per-bin gains."""
    return torch.matmul(band_e, _const(BAND_INTERP, band_e).T)


def dct(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II over the last axis (18 bands)."""
    return torch.matmul(x, _const(DCT_MATRIX, x))


def idct(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-III (inverse DCT-II) over the last axis."""
    return torch.matmul(x, _const(DCT_MATRIX, x).T)


def band_energy_from_cepstrum(ceps: torch.Tensor) -> torch.Tensor:
    """10^idct(ceps + 4 at DC) * compensation (src/freq.c:310-318)."""
    tmp = ceps[..., :NB_BANDS].to(torch.float32).clone()
    tmp[..., 0] += 4.0
    return torch.pow(10.0, idct(tmp)) * _const(COMPENSATION, tmp)


def log_band_energy(band_e: torch.Tensor) -> torch.Tensor:
    """log10 band energies with the reference's floor/follow smoothing
    (src/lpcnet_enc.c:513-520): each band is floored by the running maximum
    less 8 and by the previous follower less 2.5; 18 dependent steps."""
    ly_raw = torch.log10(1e-2 + band_e)
    log_max = torch.full_like(ly_raw[..., 0], -2.0)
    follow = torch.full_like(ly_raw[..., 0], -2.0)
    out = []
    for i in range(ly_raw.shape[-1]):
        ly = torch.maximum(log_max - 8.0,
                           torch.maximum(follow - 2.5, ly_raw[..., i]))
        log_max = torch.maximum(log_max, ly)
        follow = torch.maximum(follow - 2.5, ly)
        out.append(ly)
    return torch.stack(out, dim=-1)


def cepstrum_from_band_energy(band_e: torch.Tensor) -> torch.Tensor:
    """Band energies -> 18-dim cepstrum with the -4 DC offset
    (src/lpcnet_enc.c:513-522)."""
    ceps = dct(log_band_energy(band_e))
    ceps[..., 0] -= 4.0
    return ceps


def frame_analysis(frame: torch.Tensor, overlap_mem: torch.Tensor):
    """One 10 ms analysis step (src/lpcnet_enc.c:488-496): frame [..., 160]
    pre-emphasised, overlap_mem [..., 160] the previous frame. Returns
    (spec [..., 161] complex, band_e [..., 18], new_overlap_mem)."""
    x = torch.cat([overlap_mem, frame], dim=-1)
    spec = forward_transform(apply_window(x))
    return spec, compute_band_energy(spec), frame
