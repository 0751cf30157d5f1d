"""The least arithmetic of a DRED encoding tick, counted from the shapes of
configuration dred-rdovae-256-80 and of the encoder-side analysis
(`reference/frozen/codec/features.py`): the figures `mfu.dred` divides by
the window. Only the products a tick needs, each once, at float32's peak
(the configuration's precision):

- the analysis of one 10 ms frame: the 320-point real FFT (5 N log2 N / 2
  flops), the window, the band energies, the DCT to the cepstrum, the way
  back to the LPC (inverse DCT, band gains to bins, the 320-point inverse
  FFT, Levinson of order 16), the excitation FIR, and for each half-frame
  the 256-lag correlation, the lags' energies and the 3x interpolation;
- the RDO-VAE's encoder step (a dframe, 2 frames): dense_1, three GRUs
  (input and recurrent products), dense_2 to dense_5, the k=4 conv over the
  concatenated outputs and the two state denses.

Quantisation, the PVQ search and the entropy coding are left out: they are
a few thousand operations a stream, bookkeeping beside these.
"""

from __future__ import annotations

import math

from .peaks import PEAK

FRAME, WINDOW, BANDS, LPC, LAGS, HALF, TAPS = 160, 320, 18, 16, 256, 80, 7
BINS = WINDOW // 2 + 1


def fft_flops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def feature_frame_flops() -> float:
    """Flops of one stream's 10 ms analysis frame."""
    macs = (BINS * BANDS                  # band energies
            + BANDS * BANDS               # DCT
            + BANDS * BANDS + BANDS * BINS  # inverse DCT, gains to bins
            + LPC * LPC                   # Levinson
            + FRAME * (LPC + 1)           # excitation FIR
            + 2 * 2 * LAGS * HALF         # correlation and energies, 2 halves
            + 2 * 2 * TAPS * LAGS)        # interpolation, both ways, 2 halves
    return 2 * macs + 2 * fft_flops(WINDOW) + WINDOW + 3 * BINS


def encoder_dframe_macs(c: dict) -> int:
    """MACs of one stream's RDO-VAE encoder step."""
    cs, c2 = c["cond_size"], c["cond_size2"]
    concat = 5 * cs + 3 * c2
    return (c["enc_frames_per_step"] * c["num_features"] * c2     # dense_1
            + 3 * (3 * cs * (c2 + cs))                            # GRU 1-3
            + 2 * cs * c2 + 2 * cs * cs                           # dense_2..5
            + c["conv_kernel"] * concat * c["latent_dim"]         # conv
            + concat * c["state_hidden"]
            + c["state_hidden"] * c["state_dim"])                 # state denses


def tick_seconds(c: dict, streams: int) -> float:
    """The least device time of one tick (2 frames, 1 dframe a stream)."""
    flops = 2 * feature_frame_flops() + 2 * encoder_dframe_macs(c)
    return streams * flops / PEAK["f32"]
