"""Time lpcnet_torch's GRU training recurrence (K5 at 384 units, forward and
backward), its free-running sample loop (K1) and the loop's merged form
(K6) on one CUDA card, for the checkout at CHECKOUT (default: this
repository), so that two versions can be compared within one run:

    python tools/time_k5_k1_torch.py [CHECKOUT] [--label NAME]

It builds that checkout's kernels, then times, with CUDA events after a
warm-up launch: one K5 forward (`gru_train.gru_recurrence` without
gradients, 3 launches) and one K5 backward (`torch.autograd.grad` through
it, 3 launches) at the training shape, B=128, T=2400, N=384, on seeded
weights; and one K1 launch (`sample_loop.synthesize_frame_kernel`, 10
launches) at B=1024, n=160 on the demo vocoder's bf16, q8 and f32 bundles
(as the decoder builds them), and at B=4 on the f32 bundle (the held-out
validator's shape, 20 launches), and one K6 launch
(`sample_loop.synthesize_frame_merged_kernel`, 10 launches) on the bf16
and f32 bundles' merged operands, and K1 on the int8-loaded vocoder's q8
bundles in the factored embedding (`sample_loop.set_emb("factored")`) and
the composed one, from a fresh state on seeded conditioning. It prints
one JSON line {"label", "card", "ms": {...}}. Run
the parent and the change alternately (parent, change, change, parent) in
one call; every process reads the same seeded inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _time(fn, reps, torch):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    from lpcnet_torch.kernels import gru_train as G
    from lpcnet_torch.kernels import sample_loop as K
    from lpcnet_torch.models import lpcnet as M
    from lpcnet_torch.nn.quantized import quantize_fused

    if not torch.cuda.is_available():
        sys.exit("time_k5_k1_torch: CUDA is not available")
    _build.build_all(["sample_loop", "masked_loop", "gru_train"])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = {}

    # K5 backward, B=128, T=2400, N=384 (the recipe of chip_smoke.py's gru_case)
    n, b, t = 384, 128, 2400
    rs = np.random.RandomState(7)
    f = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32)).to(dev)
    kernel, wr0 = f(512, 3 * n) * 0.05, f(n, 3 * n) * float(0.8 / np.sqrt(n))
    bias, x, h0, w = f(2, 3 * n) * 0.1, f(b, t, 512), f(b, n) * 0.3, f(b, t, n)
    wr = wr0.clone().requires_grad_(True)
    br = bias[1].clone().requires_grad_(True)
    gi = G.gate_input({"kernel": kernel, "bias": bias}, x).requires_grad_(True)
    with torch.no_grad():
        ms["k5_fwd[384] B=128 T=2400"] = _time(
            lambda: G.gru_recurrence(wr, br, gi, h0), 3, torch)
    hs, ht = G.gru_recurrence(wr, br, gi, h0)
    dht = torch.zeros_like(ht)
    ms["k5_bwd[384] B=128 T=2400"] = _time(lambda: torch.autograd.grad(
        (hs, ht), (wr, br, gi), (w, dht), retain_graph=True), 3, torch)
    del hs, ht, gi, x
    torch.cuda.empty_cache()

    # K1 at B=1024 and (f32, the validator's shape) B=4, n=160
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    pack = getattr(K, "masked_kernel_weights", lambda kw: kw)

    def inputs(b):
        rs = np.random.RandomState(1)
        feats = torch.from_numpy((rs.normal(size=(3, b, 36)) * 0.3).astype(np.float32)).to(dev)
        fs = M.init_frame_state(b, cfg, dev)
        for k in range(3):
            fs, _, ca, cb, lpc = M.frame_network(fused, fs, feats[k], cfg)
        return ca.contiguous(), cb.contiguous(), lpc.contiguous(), M.init_sample_state(b, cfg, dev)

    ca, cb, lpc, s0 = inputs(1024)
    for form, kw in (("bf16", K.kernel_weights(fused, cfg)),
                     ("q8", K.kernel_weights(quantize_fused(fused), cfg)),
                     ("f32", K.kernel_weights(fused, cfg, dtype=torch.float32))):
        kw = pack(kw)
        ms[f"k1[{form}] B=1024 n=160"] = _time(
            lambda: K.synthesize_frame_kernel(kw, s0, ca, cb, lpc), 10, torch)
        if form != "q8":
            mw = K.merged_kernel_weights(kw)
            ms[f"k6[{form}] B=1024 n=160"] = _time(
                lambda: K.synthesize_frame_merged_kernel(mw, s0, ca, cb, lpc), 10, torch)
    # the factored q8 embedding (LPCNET_EMB=factored) on the int8-loaded
    # vocoder, beside that model's composed q8 bundle, same inputs
    fq, _ = api.load_model(api.DEMO_MODEL_PATH, int8=True, device=dev)
    prev = K.set_emb("factored")
    try:
        kwf = pack(K.kernel_weights(fq, cfg))
    finally:
        K.set_emb(prev)
    kwc = pack(K.kernel_weights(fq, cfg))
    for form, kw in (("q8 factored", kwf), ("q8 composed, int8 model", kwc)):
        ms[f"k1[{form}] B=1024 n=160"] = _time(
            lambda: K.synthesize_frame_kernel(kw, s0, ca, cb, lpc), 10, torch)
    kw = pack(K.kernel_weights(fused, cfg, dtype=torch.float32))
    ca4, cb4, lpc4, s4 = inputs(4)
    ms["k1[f32] B=4 n=160"] = _time(
        lambda: K.synthesize_frame_kernel(kw, s4, ca4, cb4, lpc4), 20, torch)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": ns.label or root, "card": card, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
