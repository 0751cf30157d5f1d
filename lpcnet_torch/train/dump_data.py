"""Training-data generation: the dump_data augmentation pipeline.

Counterpart of `lpcnet_tpu/train/dump_data.py`, a port of the reference tool
(src/dump_data.c:110-306): the sequential host-bound pieces (the
time-varying biquads, the noisy-excitation teacher loop) run in the native
runtime (`runtime.bindings`); feature extraction runs on the device over
fixed chunks of frames (`codec.features.compute_single_frame_features_seq`).

Writes the two training files that train.data.LPCNetLoader reads:
  features.f32 : 36 floats per 10 ms frame (20 used + 16 LPC)
  data.s16     : interleaved (sig_in, sig_out) int16 pairs, 2 per sample
and with `burg=True` the [burg 36 | features 36] rows of the PLC trainer.

    python -m lpcnet_torch.train.dump_data -train in.s16 features.f32 data.s16

`dump_data` and `dump_data_streams` run on CUDA unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec import features as F
from ..dsp.constants import FRAME_SIZE, PREEMPHASIS, TRAINING_OFFSET
from ..runtime import runtime
from ..utils.device import resolve_device

HP_B = np.array([-2.0, 1.0], np.float32)
HP_A = np.array([-1.99599, 0.99600], np.float32)
GAIN_CHANGE_FRAMES = 2821


class AugmentationState:
    def __init__(self, seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self.mem_hp = np.zeros(2, np.float32)
        self.mem_resp = np.zeros(2, np.float32)
        self.a_sig = np.zeros(2, np.float32)
        self.b_sig = np.zeros(2, np.float32)
        self.speech_gain = 1.0
        self.old_speech_gain = 1.0
        self.noise_std = 0.0
        self.gain_change_count = 0

    def maybe_change(self):
        """Random gain / filter / noise refresh (src/dump_data.c:246-257)."""
        self.gain_change_count += 1
        if self.gain_change_count > GAIN_CHANGE_FRAMES:
            r = self.rng
            self.speech_gain = 10.0 ** ((-30 + r.randint(40)) / 20.0)
            if r.randint(2):
                self.speech_gain = -self.speech_gain
            if r.randint(20) == 0:
                self.speech_gain *= 0.01
            if r.randint(100) == 0:
                self.speech_gain = 0.0
            self.gain_change_count = 0
            self.a_sig = (0.75 * (r.rand(2) - 0.5)).astype(np.float32)
            self.b_sig = (0.75 * (r.rand(2) - 0.5)).astype(np.float32)
            t1, t2 = r.rand(), r.rand()
            self.noise_std = abs(-1.5 * np.log(1e-4 + t1)
                                 - 0.5 * np.log(1e-4 + t2))

    def process_frame(self, frame: np.ndarray, training: bool = True
                      ) -> np.ndarray:
        """HP filter (always) + random response / gain ramp (training
        only), as src/dump_data.c:246-265, where only the randomization is
        gated on training mode."""
        if training:
            self.maybe_change()
        x = runtime.biquad(frame.astype(np.float32), HP_B, HP_A, self.mem_hp)
        x = runtime.biquad(x, self.b_sig, self.a_sig, self.mem_resp)
        f = np.arange(FRAME_SIZE, dtype=np.float32) / FRAME_SIZE
        g = f * self.speech_gain + (1 - f) * self.old_speech_gain
        x = x * g
        self.old_speech_gain = self.speech_gain
        return x


def _features_of(feat_fn, state, pcm: np.ndarray, dev):
    """feat_fn on a [B, n] host block -> (state, [B, frames, 36] numpy)."""
    with torch.no_grad():
        state, f = feat_fn(state, torch.from_numpy(
            np.ascontiguousarray(pcm, np.float32)).to(dev))
    return state, f.cpu().numpy()


def _burg_rows(frames: np.ndarray, dev) -> np.ndarray:
    """[n, 160] augmented pre-preemphasis frames -> [n, 36] Burg cepstra."""
    from ..dsp.burg import burg_cepstral_analysis
    with torch.no_grad():
        return burg_cepstral_analysis(
            torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
        ).cpu().numpy()


def dump_data_streams(speech: np.ndarray, features_out: str,
                      pcm_out: str | None = None, seed: int = 0,
                      chunk_frames: int = 1000, burg: bool = False,
                      min_samples: int | None = None, streams: int = 16,
                      device=None):
    """Multi-stream dump_data: the same per-stream arithmetic, the analysis
    batched over S streams.

    The (cycled) input splits into `streams` independent streams, each with
    its own augmentation chain, preemphasis and noise state (the reference's
    sequential semantics hold within a stream; a stream boundary is a file
    boundary), and feature extraction runs over all S streams at once in
    chunks of `chunk_frames` frames. The outputs are written stream-major,
    so the loaders see S file-boundary discontinuities.

    Quantize mode is not supported here (use `dump_data`). Returns the Burg
    rows [S, m, 36] with `burg`, else None.
    """
    dev = resolve_device(device)
    speech = np.asarray(speech)
    n_total = (len(speech) if min_samples is None
               else max(min_samples, len(speech)))
    n_frames_total = n_total // FRAME_SIZE
    m = n_frames_total // streams          # frames per stream
    if m < chunk_frames:
        chunk_frames = max(1, m)
    src = speech[: len(speech) // FRAME_SIZE * FRAME_SIZE].astype(np.float32)
    reps = int(np.ceil(streams * m * FRAME_SIZE / len(src)))
    audio = np.tile(src, reps)[: streams * m * FRAME_SIZE]
    audio = audio.reshape(streams, m, FRAME_SIZE)

    training = pcm_out is not None
    # per-stream augmentation (host): HP + random response / gain chains
    proc = np.empty_like(audio)
    noise_stds = np.empty((streams, m), np.float32)
    for s in range(streams):
        aug = AugmentationState(seed + 1000 * s + 17)
        for k in range(m):
            proc[s, k] = aug.process_frame(audio[s, k], training=training)
            noise_stds[s, k] = aug.noise_std

    # keep the augmented pre-preemphasis signal: the Burg cepstra are
    # computed on it (src/dump_data.c:266-271 runs burg before the
    # preemphasis at :271-272)
    aug_proc = proc.reshape(streams, -1)
    # preemphasis + dither, vectorized per stream
    rng = np.random.RandomState(seed + 1)
    flat = proc.reshape(streams, -1)
    prev = np.concatenate([np.zeros((streams, 1), np.float32),
                           flat[:, :-1]], axis=1)
    y = flat - PREEMPHASIS * prev
    y += (rng.rand(*y.shape) - 0.5).astype(np.float32)
    proc = y.astype(np.float32)                       # [S, m*160]

    # half-frame-delayed pcm alignment (src/dump_data.c:273-274,297)
    pcm = np.concatenate([np.zeros((streams, TRAINING_OFFSET), np.float32),
                          proc[:, :-TRAINING_OFFSET]], axis=1)
    pcm = np.clip(np.floor(0.5 + pcm), -32767, 32767).astype(np.float32)

    # feature extraction on the device, S streams at a time
    enc_state = F.init_encoder_state(streams, dev)
    feats = np.empty((streams, m, 36), np.float32)
    for c0 in range(0, m, chunk_frames):
        c1 = min(c0 + chunk_frames, m)
        enc_state, feats[:, c0:c1] = _features_of(
            F.compute_single_frame_features_seq, enc_state,
            proc[:, c0 * FRAME_SIZE: c1 * FRAME_SIZE], dev)

    burg_rows = None
    if burg:
        burg_rows = np.empty((streams, m, 36), np.float32)
        for s in range(streams):
            burg_rows[s] = _burg_rows(aug_proc[s].reshape(m, FRAME_SIZE), dev)

    # stream-major output; per-stream native noise / teacher loops
    with open(features_out, "wb") as ffeat:
        if burg:
            merged = np.concatenate([burg_rows, feats], axis=2)
            merged.reshape(-1, 72).astype(np.float32).tofile(ffeat)
        else:
            feats.reshape(-1, 36).astype(np.float32).tofile(ffeat)
    if training:
        with open(pcm_out, "wb") as fpcm:
            for s in range(streams):
                sig_mem = np.zeros(16, np.float32)
                exc_mem = np.zeros(1, np.int32)
                noise = runtime.compute_noise_frames(
                    noise_stds[s], seed=seed + 7919 * s)
                pairs = runtime.write_audio_frames(
                    pcm[s], np.ascontiguousarray(feats[s, :, 20:36]),
                    noise, sig_mem, exc_mem)
                fpcm.write(pairs.tobytes())
    return burg_rows


def _quantized_features(cbs):
    """The -qtrain / -qtest feature function: pcm [B, 640 t] -> (state,
    features [B, 4 t, 36]) through the full 40 ms quantize path
    (src/dump_data.c:288-293)."""
    from ..codec.encoder import encode_superframe

    def feat_fn(st, pcm_flat):
        b = pcm_flat.shape[0]
        rows = []
        for k in range(pcm_flat.shape[-1] // 640):
            st, feats_q, _ = encode_superframe(
                st, pcm_flat[:, k * 640:(k + 1) * 640], cbs)
            rows.append(feats_q)
        return st, torch.cat(rows, dim=1).reshape(b, -1, 36)
    return feat_fn


def dump_data(speech: np.ndarray, features_out: str, pcm_out: str | None = None,
              seed: int = 0, chunk_frames: int = 400, burg: bool = False,
              min_samples: int | None = None, quantize: bool = False,
              device=None):
    """Run the augmentation + feature pipeline over a speech array.

    Args:
      speech: int16 (or float) 16 kHz mono samples.
      features_out: output path for 36-float feature rows.
      pcm_out: output path for int16 (sig_in, sig_out) pairs; None = test
        mode (features only, no augmentation noise loop).
      min_samples: keep cycling through the input until this many samples
        are processed (the reference loops the file; default one pass).
      quantize: features through the codec's quantizer, 40 ms at a time.
    Returns the Burg rows [frames, 36] with `burg`, else None.
    """
    dev = resolve_device(device)
    speech = np.asarray(speech)
    n_total = (len(speech) if min_samples is None
               else max(min_samples, len(speech)))
    n_frames_total = n_total // FRAME_SIZE
    if quantize:
        n_frames_total = n_frames_total // 4 * 4

    aug = AugmentationState(seed)
    training = pcm_out is not None
    rng = np.random.RandomState(seed + 1)
    mem_preemph = np.zeros(1, np.float32)
    sig_mem = np.zeros(16, np.float32)
    exc_mem = np.zeros(1, np.int32)
    pcm_carry = np.zeros(TRAINING_OFFSET, np.float32)

    enc_state = F.init_encoder_state(1, dev)
    if quantize:
        from ..codec.codebooks import load_codebooks
        feat_fn = _quantized_features(load_codebooks(device=dev))
        chunk_frames = max(4, chunk_frames // 4 * 4)    # superframe-aligned
    else:
        feat_fn = F.compute_single_frame_features_seq

    ffeat = open(features_out, "wb")
    fpcm = open(pcm_out, "wb") if training else None
    fburg = []

    done = 0
    src_pos = 0
    while done < n_frames_total:
        n = min(chunk_frames, n_frames_total - done)
        # n frames of source audio (cycling)
        frames = np.empty((n, FRAME_SIZE), np.float32)
        for k in range(n):
            if src_pos + FRAME_SIZE > len(speech):
                src_pos = 0
            frames[k] = speech[src_pos: src_pos + FRAME_SIZE]
            src_pos += FRAME_SIZE

        noise_stds = np.empty(n, np.float32)
        proc = np.empty_like(frames)
        for k in range(n):
            proc[k] = aug.process_frame(frames[k], training=training)
            noise_stds[k] = aug.noise_std
        if burg:
            fburg.append(_burg_rows(proc, dev))

        # preemphasis + dither (src/dump_data.c:271-272)
        flat = proc.reshape(-1)
        prev = np.concatenate([[0.0], flat[:-1]]).astype(np.float32)
        y = flat - PREEMPHASIS * prev
        y[0] = flat[0] + mem_preemph[0]
        mem_preemph[0] = -PREEMPHASIS * flat[-1]
        # the reference dithers unconditionally (src/dump_data.c:272)
        y = y + (rng.rand(len(y)) - 0.5).astype(np.float32)
        proc = y.reshape(n, FRAME_SIZE)

        # half-frame-delayed pcm alignment (src/dump_data.c:273-274,297)
        shifted = np.concatenate([pcm_carry,
                                  proc.reshape(-1)[:-TRAINING_OFFSET]])
        pcm = shifted.reshape(n, FRAME_SIZE)
        pcm_carry = proc.reshape(-1)[-TRAINING_OFFSET:].copy()
        pcm = np.clip(np.floor(0.5 + pcm), -32767, 32767)

        enc_state, feats = _features_of(feat_fn, enc_state,
                                        proc.reshape(1, -1), dev)
        feats = feats[0]                                 # [n, 36]
        ffeat.write(feats.astype(np.float32).tobytes())

        if training:
            noise = runtime.compute_noise_frames(noise_stds, seed=seed + done)
            pairs = runtime.write_audio_frames(
                pcm.reshape(-1), feats[:, 20:36].copy(), noise, sig_mem,
                exc_mem)
            fpcm.write(pairs.tobytes())
        done += n

    ffeat.close()
    if fpcm:
        fpcm.close()
    if burg:
        return np.concatenate(fburg)
    return None


def main(argv=None):
    """CLI mirroring the reference dump_data modes (src/dump_data.c:145-171):
    -train/-test (+ burg and quantize variants) and feature-domain -decode."""
    import argparse
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    # accept the reference's dash-prefixed modes (-train etc.)
    modes = {"train", "test", "btrain", "btest", "decode", "qtrain", "qtest"}
    if argv and argv[0].lstrip("-") in modes:
        argv[0] = argv[0].lstrip("-")
    ap = argparse.ArgumentParser(prog="lpcnet_torch.train.dump_data")
    ap.add_argument("mode", choices=sorted(modes))
    ap.add_argument("input")
    ap.add_argument("features_out")
    ap.add_argument("pcm_out", nargs="?", default=None)
    ap.add_argument("--seconds", type=float, default=None,
                    help="cycle input until this many seconds are generated")
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    mode = ns.mode
    dev = resolve_device(ns.device)

    if mode == "decode":
        from ..codec import packet as P
        from ..codec.codebooks import load_codebooks
        from ..codec.decoder import decode_packet_features
        data = np.fromfile(ns.input, np.uint8).reshape(-1, 8)
        cbs = load_codebooks(device=dev)
        vq = torch.zeros((1, 18), device=dev)
        with open(ns.features_out, "wb") as f, torch.no_grad():
            for row in data:
                fields = {k: torch.as_tensor(v, device=dev)[None]
                          for k, v in P.unpack_fields(row).items()}
                feats, vq = decode_packet_features(fields, vq, cbs)
                f.write(feats[0].cpu().numpy().astype(np.float32).tobytes())
        return 0

    speech = np.fromfile(ns.input, dtype=np.int16)
    training = mode in ("train", "btrain", "qtrain")
    burg = mode in ("btrain", "btest")
    min_samples = int(ns.seconds * 16000) if ns.seconds else None
    burg_feats = dump_data(speech, ns.features_out,
                           ns.pcm_out if training else None,
                           burg=burg, min_samples=min_samples,
                           quantize=mode in ("qtrain", "qtest"), device=dev)
    if burg and burg_feats is not None:
        # the PLC trainer's rows: the Burg rows before the feature rows
        feats = np.fromfile(ns.features_out, np.float32).reshape(-1, 36)
        n = min(len(feats), len(burg_feats))
        merged = np.concatenate([burg_feats[:n], feats[:n]], axis=1)
        merged.astype(np.float32).tofile(ns.features_out)
    return 0


if __name__ == "__main__":
    main()
