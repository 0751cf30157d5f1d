"""Time lpcnet_torch's masked sample-loop kernel (K2) on one CUDA card, for
the checkout at CHECKOUT (default: this repository), so that two versions
can be compared within one run:

    python tools/time_k2_torch.py [CHECKOUT] [--label NAME]

It builds that checkout's kernels, then times one K2 launch (CUDA events,
20 launches after 2 of warm-up) on the demo vocoder's f32, bf16 and q8
bundles, and the int8-loaded vocoder's q8 bundles in the factored
embedding (`sample_loop.set_emb("factored")`) and the composed one, at the
training path's shape (128 streams, one 160-sample frame,
every stream advancing, three quarters of the samples teacher-forced in
runs of 16), at a PLC half-frame (64 streams, 80 samples) and at 256
streams, and prints one JSON line {"label", "card", "ms": {...}}. Run the
parent and the change alternately (parent, change, change, parent) in one
call; every process reads the same seeded inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", nargs="?",
                    default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    ns = ap.parse_args(argv)
    root = os.path.abspath(ns.checkout)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from lpcnet_torch import api
    from lpcnet_torch.kernels import _build
    from lpcnet_torch.kernels import sample_loop as K
    from lpcnet_torch.models import lpcnet as M
    from lpcnet_torch.nn.quantized import quantize_fused

    if not torch.cuda.is_available():
        sys.exit("time_k2_torch: CUDA is not available")
    names = [n for n in ("sample_loop", "masked_loop")
             if os.path.exists(os.path.join(root, "lpcnet_torch/kernels/csrc", n + ".cu"))]
    _build.build_all(names)
    dev = torch.device("cuda")
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    pack = getattr(K, "masked_kernel_weights", lambda kw: kw)
    bundles = {"bf16": pack(K.kernel_weights(fused, cfg)),
               "q8": pack(K.kernel_weights(quantize_fused(fused), cfg)),
               "f32": pack(K.kernel_weights(fused, cfg, dtype=torch.float32))}
    # the factored q8 embedding on the int8-loaded vocoder, and that model's
    # composed q8 bundle
    fq, _ = api.load_model(api.DEMO_MODEL_PATH, int8=True, device=dev)
    prev = K.set_emb("factored")
    try:
        bundles["q8 factored"] = pack(K.kernel_weights(fq, cfg))
    finally:
        K.set_emb(prev)
    bundles["q8 composed, int8 model"] = pack(K.kernel_weights(fq, cfg))
    ms = {}
    for b, n in ((128, 160), (64, 80), (256, 160)):
        rs = np.random.RandomState(1)
        feats = torch.from_numpy((rs.normal(size=(3, b, 36)) * 0.3).astype(np.float32)).to(dev)
        fs = M.init_frame_state(b, cfg, dev)
        for k in range(3):
            fs, _, ca, cb, lpc = M.frame_network(fused, fs, feats[k], cfg)
        ca, cb, lpc = ca.contiguous(), cb.contiguous(), lpc.contiguous()
        s0 = M.init_sample_state(b, cfg, dev)
        tg = torch.from_numpy((rs.normal(size=(b, n)) * 1000).astype(np.float32)).to(dev)
        tf = torch.from_numpy(np.repeat(rs.rand(b, 10) < 0.75, 16, axis=1)[:, :n].copy()).to(dev)
        adv = torch.ones((b, n), dtype=torch.bool, device=dev)
        for form, kw in bundles.items():
            run = lambda: K.synthesize_frame_masked_kernel(kw, s0, ca, cb, lpc, tg, tf, adv, n)
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(20):
                run()
            end.record()
            torch.cuda.synchronize()
            ms[f"{form} B={b} n={n}"] = start.elapsed_time(end) / 20
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": ns.label or root, "card": card, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
