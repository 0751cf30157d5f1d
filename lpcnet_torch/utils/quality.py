"""Intrusive speech-quality proxies for model A/Bs: the counterpart of
`lpcnet_tpu/utils/quality.py`.

Three metrics over aligned original / synthesised PCM, all from one batched
band-energy analysis (non-overlapping 20 ms windows through the codec's
`apply_window`, `forward_transform` and `compute_band_energy`):

- band-LSD: mean |dB| distance over the codec's 18 Opus-style bands;
- MCD: mel-cepstral distortion's formula (10 sqrt(2) / ln 10 times the
  L2 distance of cepstra c1..c17) over the DCT of the log band energies.
  The bands are the codec's own, not a mel filterbank, so the values are
  for A/Bs within this repo, not for comparison with published MCDs;
- fwSegSNR: frequency-weighted segmental SNR (Hu & Loizou 2008): per-band
  SNR weighted by the clean band energy^0.2, clamped to [-10, 35] dB.

The band analysis runs on `device` (the CPU by default); the rest is numpy.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

_EPS = 1e-2  # the band-LSD floor of the JAX package's evaluations


def _band_log_energies(pcm: np.ndarray, device="cpu"):
    """(10 log10 band energies, raw band energies), each [T, 18], over
    non-overlapping 20 ms windows."""
    from ..dsp import spectrum

    n = len(pcm) // 320 * 320
    w = torch.as_tensor(np.asarray(pcm[:n], np.float32).reshape(-1, 320),
                        device=device)
    e = spectrum.compute_band_energy(
        spectrum.forward_transform(spectrum.apply_window(w))).cpu().numpy()
    return 10.0 * np.log10(e + _EPS), e


def quality_metrics(ref_pcm: np.ndarray, test_pcm: np.ndarray, device="cpu"
                    ) -> Dict[str, float]:
    """All metrics between a reference clip and a synthesised clip.

    The clips must be time-aligned already (callers strip the model's
    lookahead); samples past the common 20 ms grid are ignored.
    """
    n = min(len(ref_pcm), len(test_pcm))
    la, ea = _band_log_energies(ref_pcm[:n], device)
    lb, eb = _band_log_energies(test_pcm[:n], device)

    band_lsd = float(np.mean(np.abs(la - lb)))

    # MCD: orthonormal DCT-II cepstra of the ln band energies, c1..c17
    def ceps(ldb):
        ln_e = ldb * (math.log(10.0) / 10.0)
        _, b = ln_e.shape
        k = np.arange(b)
        basis = np.cos(math.pi * (np.arange(b)[:, None] + 0.5) * k[None, :]
                       / b) * math.sqrt(2.0 / b)
        basis[:, 0] /= math.sqrt(2.0)
        return ln_e @ basis
    ca, cb = ceps(la), ceps(lb)
    mcd = float(np.mean(np.sqrt(np.sum((ca[:, 1:] - cb[:, 1:]) ** 2, axis=1)))
                * 10.0 * math.sqrt(2.0) / math.log(10.0))

    # fwSegSNR: weight = clean band energy^0.2; the frames below the 5th
    # percentile of total energy count as silence and are left out
    diff = np.maximum(np.abs(ea - eb), 1e-10)
    snr = np.clip(10.0 * np.log10(np.maximum(ea, 1e-10) / diff), -10.0, 35.0)
    w = np.power(np.maximum(ea, 1e-10), 0.2)
    frame_e = np.sum(ea, axis=1)
    act = frame_e > np.percentile(frame_e, 5.0)
    fw = np.sum(w * snr, axis=1) / np.sum(w, axis=1)
    fwsegsnr = float(np.mean(fw[act])) if act.any() else float(np.mean(fw))

    return {"band_lsd_db": band_lsd, "mcd_db": mcd, "fwsegsnr_db": fwsegsnr}


def format_metrics(m: Dict[str, float]) -> str:
    return (f"band-LSD {m['band_lsd_db']:.3f} dB  "
            f"MCD {m['mcd_db']:.3f} dB  fwSegSNR {m['fwsegsnr_db']:.2f} dB")
