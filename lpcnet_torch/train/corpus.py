"""Synthetic speech-like corpus generator for demo training runs: a copy of
`lpcnet_tpu/train/corpus.py` (numpy and scipy only), so that the two
packages generate the same corpus from the same seed.

The reference trains on hours of real speech (README.md:104-117: "suitable
training material" from e.g. the McGill/NTT databases); this image ships
none, so demo checkpoints train on synthetic audio. The round-1 generator
(two fixed formants per utterance, no consonants, binary voicing gate) was
identified as the demo-model quality bottleneck (NOTES.md): models
plateaued because the data lacked the spectro-temporal variety the
features/codec exercise.

This generator produces segment-structured pseudo-speech with the acoustic
phenomena the LPCNet feature chain actually measures:

- a source-filter model with FOUR time-varying formant resonators
  (piecewise-linear tracks with coarticulation glides, per-speaker formant
  scaling) so the 18-band spectrum and the 16th-order LPC both have real
  structure to fit;
- segment types: vowels (table of 7 targets), nasals (darker, low F1),
  voiced+unvoiced fricatives (constriction-shaped noise), plosives
  (closure silence + burst + aspiration), and inter-utterance pauses --
  consonant transients exercise the pitch tracker's unvoiced handling and
  the codec's energy dynamics;
- prosody: per-utterance f0 declination with random accent bumps, per-
  period jitter and shimmer, speaking-rate and loudness variation, and
  per-"speaker" pitch ranges (85-230 Hz) so the pitch quantizer's whole
  log-range gets data.

Pure numpy/scipy on the host: corpus generation is one-time data prep
(the reference's equivalent concern lives in dump_data.c augmentation,
which runs downstream of this, train/dump_data.py).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

FS = 16000

# vowel formant targets in Hz (F1, F2, F3); F4 rides ~3400 w/ small jitter
_VOWELS = np.array([
    (270, 2290, 3010),   # i
    (390, 1990, 2550),   # I
    (530, 1840, 2480),   # e
    (660, 1720, 2410),   # ae
    (730, 1090, 2440),   # a
    (570, 840, 2410),    # o
    (440, 1020, 2240),   # U
    (300, 870, 2240),    # u
    (490, 1350, 2500),   # schwa
], np.float64)
_NASALS = np.array([
    (250, 1000, 2200),   # m
    (250, 1450, 2300),   # n
], np.float64)
# fricative constriction band (lo, hi) Hz and voicing flag
_FRICS = [
    ((3800, 7600), False),   # s
    ((1800, 3600), False),   # sh
    ((800, 7000), False),    # f/th (flat, weak)
    ((3500, 7200), True),    # z
    ((1700, 3400), True),    # zh/v
]
_BWS = np.array([80.0, 110.0, 160.0, 220.0])     # formant bandwidths


def _biquad_coef(f, bw):
    """2nd-order resonator (peak-normalized-ish) at f Hz, bandwidth bw."""
    r = np.exp(-np.pi * bw / FS)
    a1 = -2.0 * r * np.cos(2 * np.pi * f / FS)
    a2 = r * r
    return np.array([1.0 - r, 0.0, 0.0]), np.array([1.0, a1, a2])


def _formant_cascade(x, tracks, block=320):
    """Run x through 4 resonators whose centers follow `tracks` [n, 4],
    updating coefficients every `block` samples with carried filter state
    (the standard time-varying-filter block trick; exact continuity via
    lfilter zi)."""
    n = len(x)
    y = x
    for k in range(4):
        out = np.empty(n)
        zi = np.zeros(2)
        for s0 in range(0, n, block):
            s1 = min(s0 + block, n)
            f = tracks[min(s0 + block // 2, n - 1), k]
            b, a = _biquad_coef(f, _BWS[k])
            out[s0:s1], zi = lfilter(b, a, y[s0:s1], zi=zi)
        y = out
    return y


def _bandpass_noise(n, lo, hi, rng):
    """Constriction noise: white noise -> 2nd-order bandpass at the band
    center (fricative spectra are broad; one resonator is plenty)."""
    f = 0.5 * (lo + hi)
    bw = max(hi - lo, 200.0)
    b, a = _biquad_coef(f, bw)
    return lfilter(b, a, rng.randn(n))


def _ramp(n, up, down):
    env = np.ones(n)
    up = min(up, n)
    down = min(down, n)
    if up:
        env[:up] = 0.5 - 0.5 * np.cos(np.pi * np.arange(up) / up)
    if down:
        env[n - down:] = np.minimum(
            env[n - down:], 0.5 + 0.5 * np.cos(np.pi * np.arange(down) / down))
    return env


def _segments(rng, rate):
    """One utterance's segment plan: mostly CV alternation with occasional
    clusters; durations in samples, scaled by speaking rate."""
    plan = []
    n_syll = rng.randint(3, 10)
    for _ in range(n_syll):
        r = rng.rand()
        if r < 0.35:
            plan.append(("plosive", int(FS * (0.04 + 0.05 * rng.rand()) * rate)))
        elif r < 0.65:
            plan.append(("fric", int(FS * (0.06 + 0.12 * rng.rand()) * rate)))
        elif r < 0.8:
            plan.append(("nasal", int(FS * (0.05 + 0.07 * rng.rand()) * rate)))
        plan.append(("vowel", int(FS * (0.08 + 0.17 * rng.rand()) * rate)))
    return plan


def _utterance(rng, speaker, voice=None):
    """voice (corpus v3): per-speaker stochastic-source parameters --
    dict(breath, jitter, shimmer, floor). v2 passes None (fixed 0.012
    aspiration floor, 1.5% jitter, 25% shimmer).

    The v3 source makes the excitation's conditional entropy given the
    features nonzero: aspiration noise is pitch-synchronously modulated and
    per-segment scaled, so no deterministic function of (cepstrum, pitch,
    corr) reproduces the waveform. This attacks the round-4 diagnosis that
    free-running quality plateaus because the pdf over-sharpens on a
    near-deterministic synthetic excitation (the reference trains on real
    speech whose source is irreducibly stochastic, README.md:103-118)."""
    f0_base, fscale, rate, loud = speaker
    plan = _segments(rng, rate)
    n = sum(d for _, d in plan)
    t = np.arange(n)

    # --- formant tracks: per-segment targets, 30 ms coarticulation glides
    keys_t, keys_f = [0], [None]
    pos = 0
    for kind, dur in plan:
        if kind == "vowel":
            tgt = _VOWELS[rng.randint(len(_VOWELS))].copy()
        elif kind == "nasal":
            tgt = _NASALS[rng.randint(len(_NASALS))].copy()
        else:
            tgt = _VOWELS[rng.randint(len(_VOWELS))] * (0.9 + 0.2 * rng.rand())
        tgt = np.append(tgt * fscale * (1 + 0.02 * rng.randn(3)),
                        3400.0 * fscale * (1 + 0.02 * rng.randn()))
        keys_t.append(pos + dur // 2)
        keys_f.append(tgt)
        pos += dur
    keys_t.append(n - 1)
    keys_f[0] = keys_f[1]
    keys_f.append(keys_f[-1])
    kf = np.stack(keys_f)
    tracks = np.stack(
        [np.interp(t, keys_t, kf[:, k]) for k in range(4)], axis=1)

    # --- prosody: declination + accents + jitter -> pulse train
    decl = np.linspace(1.0, 0.72 + 0.12 * rng.rand(), n)
    acc = np.zeros(n)
    for _ in range(rng.randint(1, 4)):
        c = rng.randint(n)
        wdt = int(FS * (0.1 + 0.2 * rng.rand()))
        lo_i, hi_i = max(0, c - wdt), min(n, c + wdt)
        acc[lo_i:hi_i] += (0.08 + 0.18 * rng.rand()) * np.hanning(hi_i - lo_i)
    f0t = f0_base * decl * (1 + acc)
    phase = np.cumsum(f0t / FS)
    pulse_idx = np.flatnonzero(np.diff(np.floor(phase), prepend=0.0) > 0)
    jit = 0.015 if voice is None else voice["jitter"]
    shim = 0.25 if voice is None else voice["shimmer"]
    # jitter: shift each pulse by a fraction of the period; shimmer: per-
    # pulse amplitude variation
    if len(pulse_idx):
        period = FS / f0t[pulse_idx]
        pulse_idx = np.clip(
            pulse_idx + np.round(period * jit * rng.randn(len(pulse_idx))
                                 ).astype(int), 0, n - 1)
    voiced_src = np.zeros(n)
    voiced_src[pulse_idx] = 1.0 + shim * rng.randn(len(pulse_idx))
    # glottal shaping: -12 dB/oct via two one-pole lowpasses + tilt noise
    voiced_src = lfilter([1.0], [1.0, -0.9], voiced_src)
    voiced_src = lfilter([1.0], [1.0, -0.7], voiced_src)
    if voice is None:
        voiced_src += 0.012 * rng.randn(n)      # v2: fixed aspiration floor
        asp_profile = None
    else:
        # v3 stochastic source: pitch-synchronous aspiration (stronger in
        # the open phase of the glottal cycle) at a per-speaker breathiness
        # level; the noise itself is added after the segment loop, scaled
        # by the per-segment floor envelope
        open_phase = phase - np.floor(phase)          # 0..1 within cycle
        asp_profile = voice["breath"] * (0.45 + 1.1 * open_phase)

    # --- per-segment source gating / consonant sources
    v_env = np.zeros(n)
    fric_out = np.zeros(n)
    asp_env = np.ones(n)
    pos = 0
    for kind, dur in plan:
        seg = slice(pos, pos + dur)
        edge = int(0.012 * FS)
        if voice is not None:
            # v3 per-segment noise floor: each segment's aspiration level
            # varies ~0.45x-2.2x (log-uniform) around the speaker level
            asp_env[seg] = np.exp(rng.uniform(-0.8, 0.8))
        if kind == "vowel":
            v_env[seg] = _ramp(dur, edge, edge)
        elif kind == "nasal":
            v_env[seg] = 0.5 * _ramp(dur, edge, edge)
        elif kind == "fric":
            (lo_f, hi_f), voiced = _FRICS[rng.randint(len(_FRICS))]
            noise = _bandpass_noise(dur, lo_f, hi_f, rng)
            amp = 0.05 + 0.10 * rng.rand()
            fric_out[seg] = amp * noise * _ramp(dur, edge, edge)
            if voiced:
                v_env[seg] = 0.35 * _ramp(dur, edge, edge)
        elif kind == "plosive":
            closure = int(dur * (0.5 + 0.2 * rng.rand()))
            burst = min(int(FS * (0.005 + 0.012 * rng.rand())),
                        dur - closure)
            b0 = pos + closure
            lo_f = 500 + 3000 * rng.rand()
            spec = _bandpass_noise(dur - closure, lo_f, lo_f + 3000, rng)
            benv = np.exp(-np.arange(dur - closure) / max(burst, 1))
            fric_out[b0:pos + dur] = (0.25 + 0.3 * rng.rand()) * spec * benv
        pos += dur

    if asp_profile is not None:
        voiced_src = voiced_src + asp_profile * asp_env * rng.randn(n)
    voiced = _formant_cascade(voiced_src * v_env, tracks)
    # balance consonant noise against the vowels by RMS over active spans
    # (peak-based scaling lets one burst spike crush the whole utterance)
    v_act = v_env > 0.2
    vr = np.sqrt(np.mean(voiced[v_act] ** 2)) if v_act.any() else 1.0
    f_act = np.abs(fric_out) > 1e-9
    fr = np.sqrt(np.mean(fric_out[f_act] ** 2)) if f_act.any() else 1.0
    out = voiced + fric_out * (0.45 * vr / max(fr, 1e-9))
    # slow loudness contour
    out *= loud * (0.75 + 0.25 * np.sin(2 * np.pi * t / n * (0.5 + rng.rand())
                                        + rng.rand() * 6.28))
    # return the loud-free voiced RMS so per-speaker `loud` survives the
    # caller's RMS normalization (returning vr*loud would cancel it exactly)
    return out, vr


def synth_corpus(seconds: float, seed: int = 0, version: int = 2
                 ) -> np.ndarray:
    """Generate `seconds` of 16 kHz int16 pseudo-speech (peak ~9000, the
    same headroom the round-1 generator used so dump_data's gain/noise
    augmentation ranges stay appropriate).

    version=2: the round-2 deterministic-source generator (kept bit-exact
    for comparability with models validated on v2 clips).
    version=3: stochastic excitation -- per-speaker breathiness with
    pitch-synchronous aspiration, wider jitter/shimmer ranges, per-segment
    noise floors, and a low room-tone floor, so the excitation carries
    irreducible entropy given the features (the round-4 exposure-bias
    diagnosis: a pdf trained on deterministic excitation over-sharpens and
    free-running sampling errors compound through the LPC feedback)."""
    rng = np.random.RandomState(seed)
    total = int(seconds * FS)
    out = np.zeros(total + FS * 8, np.float64)
    pos = 0
    speaker = None
    voice = None
    utt_left = 0
    while pos < total:
        if utt_left <= 0:
            speaker = (85 + 145 * rng.rand(),            # f0 base
                       0.88 + 0.27 * rng.rand(),          # formant scale
                       0.8 + 0.5 * rng.rand(),            # speaking rate
                       0.5 + 0.5 * rng.rand())            # loudness
            if version >= 3:
                voice = {
                    # log-uniform breathiness: modal (~35 dB HNR) to
                    # breathy (~15 dB HNR); real speech sits ~10-30 dB
                    "breath": float(np.exp(rng.uniform(np.log(0.02),
                                                       np.log(0.2)))),
                    "jitter": 0.005 + 0.035 * rng.rand(),
                    "shimmer": 0.10 + 0.35 * rng.rand(),
                }
            utt_left = rng.randint(3, 9)
        utt, vrms = _utterance(rng, speaker, voice=voice)
        utt_left -= 1
        # level by voiced RMS (peak scaling lets burst spikes crush speech)
        out[pos:pos + len(utt)] = utt / max(vrms, 1e-9) * (
            1200 + 1800 * rng.rand())
        pos += len(utt) + int(FS * (0.1 + 0.35 * rng.rand()))
    out = out[:total]
    if version >= 3:
        # room tone: low white floor (~45-55 dB below speech) keeps the
        # excitation stochastic through pauses and closures too
        out = out + (1.5 + 4.5 * rng.rand()) * rng.randn(total)
    # headroom off a high percentile, then clip the few burst spikes
    ref = np.percentile(np.abs(out), 99.9) + 1e-9
    return np.round(np.clip(out / ref * 8000, -9500, 9500)).astype(np.int16)
