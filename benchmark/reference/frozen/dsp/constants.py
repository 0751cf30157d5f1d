# Frozen copy of lpcnet_torch/dsp/constants.py at commit d7e6271, kept to its plain
# paths. Part of the benchmark's yardstick: not to be edited.
"""Audio/DSP constants of the vocoder path (numpy, no framework).

16 kHz mono audio, 10 ms frames, 20 ms analysis windows, 18 bands and
order-16 LPC, as in the reference (src/freq.h:32-49). The tables are
computed in float64 and cast to float32.
"""

from __future__ import annotations

import numpy as np

LPC_ORDER = 16
PREEMPHASIS = 0.85

WINDOW_SIZE_5MS = 4
FRAME_SIZE = 160
OVERLAP_SIZE = 160
TRAINING_OFFSET = 80      # half-frame alignment offset of pitch and PLC
WINDOW_SIZE = FRAME_SIZE + OVERLAP_SIZE   # 320
FREQ_SIZE = WINDOW_SIZE // 2 + 1          # 161 rfft bins

NB_BANDS = 18
NB_FEATURES = 20          # cepstrum(18) + pitch period + pitch corr
NB_TOTAL_FEATURES = 36    # + 16 LPC coefficients

PITCH_MIN_PERIOD = 32
PITCH_MAX_PERIOD = 256

# codec packet layout (reference include/lpcnet.h:48-53)
LPCNET_COMPRESSED_SIZE = 8
LPCNET_PACKET_SAMPLES = 4 * FRAME_SIZE

# interpolation coding: the diff codebook's predictor groups
MULTI = 4
MULTI_MASK = MULTI - 1

# band edges in 5 ms bin units (src/freq.c:45-48)
EBAND5MS = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40],
    dtype=np.int32,
)

# per-band gain compensation of the cepstrum -> band energy map
# (src/freq.c:50-52)
COMPENSATION = np.array(
    [0.8, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.666667, 0.5, 0.5, 0.5,
     0.333333, 0.25, 0.25, 0.2, 0.166667, 0.173913],
    dtype=np.float32,
)


def _make_half_window() -> np.ndarray:
    """Vorbis sin(pi/2 * sin^2) half window (src/dump_lpcnet_tables.c:83)."""
    i = np.arange(OVERLAP_SIZE, dtype=np.float64)
    s = np.sin(0.5 * np.pi * (i + 0.5) / OVERLAP_SIZE)
    return np.sin(0.5 * np.pi * s * s).astype(np.float32)


def _make_full_window() -> np.ndarray:
    hw = _make_half_window().astype(np.float64)
    w = np.ones(WINDOW_SIZE, dtype=np.float64)
    w[:OVERLAP_SIZE] = hw
    w[WINDOW_SIZE - OVERLAP_SIZE:] = hw[::-1]
    return w.astype(np.float32)


def _make_dct_matrix() -> np.ndarray:
    """Orthonormal DCT-II matrix: dct(x) = x @ T, idct(y) = y @ T.T."""
    n = NB_BANDS
    j = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    t = np.cos((j + 0.5) * i * np.pi / n)
    t[:, 0] *= np.sqrt(0.5)
    t *= np.sqrt(2.0 / n)
    return t.astype(np.float32)


def _make_band_interp() -> np.ndarray:
    """[FREQ_SIZE, NB_BANDS] triangular interpolation (src/freq.c:202-215)."""
    w = np.zeros((FREQ_SIZE, NB_BANDS), dtype=np.float64)
    for b in range(NB_BANDS - 1):
        band_size = int(EBAND5MS[b + 1] - EBAND5MS[b]) * WINDOW_SIZE_5MS
        start = int(EBAND5MS[b]) * WINDOW_SIZE_5MS
        for j in range(band_size):
            frac = j / band_size
            w[start + j, b] = 1.0 - frac
            w[start + j, b + 1] = frac
    return w.astype(np.float32)


def _make_band_energy_matrix() -> np.ndarray:
    """BAND_INTERP with the first and last bands doubled (src/freq.c:148)."""
    e = _make_band_interp().astype(np.float64)
    e[:, 0] *= 2.0
    e[:, NB_BANDS - 1] *= 2.0
    return e.astype(np.float32)


HALF_WINDOW = _make_half_window()
FULL_WINDOW = _make_full_window()
DCT_MATRIX = _make_dct_matrix()
BAND_INTERP = _make_band_interp()
BAND_ENERGY_MATRIX = _make_band_energy_matrix()

# 3x sinc interpolation filter of the pitch correlation
# (src/lpcnet_enc.c:557)
PITCH_INTERP = np.array(
    [0.026184, -0.098339, 0.369938, 0.837891, -0.184969, 0.070242, -0.020947],
    dtype=np.float32,
)
