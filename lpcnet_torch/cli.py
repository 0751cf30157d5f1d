"""Command-line codec and vocoder, as the reference's `lpcnet_demo`
(src/lpcnet_demo.c):

    python -m lpcnet_torch.cli encode    <input.pcm> <compressed.lpcnet>
    python -m lpcnet_torch.cli decode    <compressed.lpcnet> <output.pcm>
    python -m lpcnet_torch.cli features  <input.pcm> <features.f32>
    python -m lpcnet_torch.cli synthesis <features.f32> <output.pcm>
    python -m lpcnet_torch.cli addlpc    <features.f32> <features_lpc.f32>
    python -m lpcnet_torch.cli plc <causal|causal_dc|noncausal|noncausal_dc>
                                   <percent|pattern.txt> <input.pcm> <output.pcm>
        [--model model.npz|model.bin|random] [--device cuda|cpu]

File formats are the C demo's: .pcm raw 16 kHz s16le mono, .f32 raw float32
feature rows of 36, .lpcnet 8-byte packets (40 ms each); a loss pattern is
one 0/1 flag per 20 ms packet. Sampling is the C bit tree. The model
(decode, synthesis, the causal plc modes) defaults to the shipped demo
vocoder (lpcnet_tpu/data/demo_model.npz, read as a file); the non-causal
plc modes need a lookahead-0 model and default to a seeded random one. The
plc modes run the shipped demo PLC network. Every mode runs on the GPU
unless `--device cpu` is passed; LPCNET_KERNEL_MERGED=1 selects the merged
sample-loop kernel for float models.
"""

from __future__ import annotations

import argparse

import numpy as np

from . import api
from .dsp.constants import (FRAME_SIZE, LPCNET_COMPRESSED_SIZE,
                            LPCNET_PACKET_SAMPLES, NB_TOTAL_FEATURES)


def _read_features(path):
    feats = np.fromfile(path, dtype=np.float32)
    n = len(feats) // NB_TOTAL_FEATURES
    return feats[:n * NB_TOTAL_FEATURES].reshape(n, NB_TOTAL_FEATURES)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lpcnet_torch")
    ap.add_argument("mode", choices=["encode", "decode", "features",
                                     "synthesis", "addlpc", "plc"])
    ap.add_argument("args", nargs="+", metavar="ARG")
    ap.add_argument("--model", default=None,
                    help="model weights (.npz checkpoint or DNNw blob); "
                         "default = the shipped demo vocoder (a seeded "
                         "random one for the non-causal plc modes); "
                         "'random' for a seeded random init")
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    n_args = 4 if ns.mode == "plc" else 2
    if len(ns.args) != n_args:
        ap.error(f"{ns.mode} takes {n_args} arguments")
    if ns.model == "random":
        model = None
    elif ns.model is not None:
        model = ns.model
    elif ns.mode == "plc" and ns.args[0].startswith("noncausal"):
        model = None                        # the demo vocoder has lookahead 2
    else:
        model = api.DEMO_MODEL_PATH

    if ns.mode == "plc":
        from .plc.driver import run_plc_file
        run_plc_file(*ns.args, model_path=model, device=ns.device)
        return
    src, dst = ns.args

    if ns.mode == "encode":
        pcm = np.fromfile(src, dtype=np.int16)
        enc = api.lpcnet_encoder_create(device=ns.device)
        n = len(pcm) // LPCNET_PACKET_SAMPLES
        pkts = [api.lpcnet_encode(enc, pcm[t * LPCNET_PACKET_SAMPLES:
                                           (t + 1) * LPCNET_PACKET_SAMPLES])
                for t in range(n)]
        np.array(pkts, np.uint8).reshape(-1).tofile(dst)
        print(f"encoded {n} packets ({n * LPCNET_COMPRESSED_SIZE} bytes, "
              f"{n * 40} ms)")

    elif ns.mode == "decode":
        data = np.fromfile(src, dtype=np.uint8)
        n = len(data) // LPCNET_COMPRESSED_SIZE
        dec = api.lpcnet_decoder_create(model, device=ns.device)
        out = [np.zeros(0, np.int16)] + [
            api.lpcnet_decode(dec, data[t * LPCNET_COMPRESSED_SIZE:
                                        (t + 1) * LPCNET_COMPRESSED_SIZE])
            for t in range(n)]
        np.concatenate(out).astype(np.int16).tofile(dst)
        print(f"decoded {n} packets -> {n * LPCNET_PACKET_SAMPLES} samples")

    elif ns.mode == "features":
        pcm = np.fromfile(src, dtype=np.int16)
        enc = api.lpcnet_encoder_create(device=ns.device)
        n = len(pcm) // FRAME_SIZE
        rows = [api.lpcnet_compute_single_frame_features(
            enc, pcm[t * FRAME_SIZE:(t + 1) * FRAME_SIZE]) for t in range(n)]
        np.array(rows, np.float32).reshape(-1).tofile(dst)
        print(f"wrote {n} feature frames")

    elif ns.mode == "synthesis":
        feats = _read_features(src)
        synth = api.Synthesizer(model, batch=1, device=ns.device)
        out = [np.zeros(0, np.int16)] + [
            synth.synthesize(f[None])[0] for f in feats]
        np.concatenate(out).astype(np.int16).tofile(dst)
        print(f"synthesized {len(feats)} frames "
              f"({len(feats) * FRAME_SIZE} samples)")

    else:                                   # addlpc
        feats = _read_features(src)
        api.add_lpc_to_features(feats, device=ns.device).tofile(dst)
        print(f"added LPC to {len(feats)} frames")


if __name__ == "__main__":
    main()
