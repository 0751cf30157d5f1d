"""Command-line vocoder, as the reference's `lpcnet_demo -synthesis`
(src/lpcnet_demo.c):

    python -m lpcnet_torch.cli synthesis <features.f32> <output.pcm>
        [--model model.npz|random] [--device cuda|cpu]

features.f32 holds raw float32 rows of 36; output.pcm is raw 16 kHz s16le
mono. Sampling is the C bit tree. The model defaults to the shipped demo
vocoder (lpcnet_tpu/data/demo_model.npz, read as a file).
"""

from __future__ import annotations

import argparse

import numpy as np

from . import api
from .dsp.constants import FRAME_SIZE, NB_TOTAL_FEATURES


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lpcnet_torch")
    ap.add_argument("mode", choices=["synthesis"])
    ap.add_argument("args", nargs=2, metavar="FILE")
    ap.add_argument("--model", default=api.DEMO_MODEL_PATH,
                    help="model weights (.npz checkpoint); default = the "
                         "shipped demo vocoder; 'random' for a seeded "
                         "random init")
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)

    feats = np.fromfile(ns.args[0], dtype=np.float32)
    n = len(feats) // NB_TOTAL_FEATURES
    feats = feats[:n * NB_TOTAL_FEATURES].reshape(n, NB_TOTAL_FEATURES)
    model = None if ns.model == "random" else ns.model
    synth = api.Synthesizer(model, batch=1, device=ns.device)
    out = [np.zeros(0, np.int16)]
    for t in range(n):
        out.append(synth.synthesize(feats[t][None])[0])
    np.concatenate(out).astype(np.int16).tofile(ns.args[1])
    print(f"synthesized {n} frames ({n * FRAME_SIZE} samples)")


if __name__ == "__main__":
    main()
