"""Time lpcnet_torch's teacher-forced run (K3) and PLC-net chain (K4) on one
CUDA card, for the checkout at CHECKOUT (default: this repository), so that
two versions can be compared within one run:

    python tools/time_k3_k4_torch.py [CHECKOUT] [--label NAME] [--trace]

It builds that checkout's kernels, then times, with CUDA events after two
warm-up calls: K3 (`sample_loop.teacher_force_blocks_kernel`, 10 calls) on
the demo vocoder's f32, bf16 and q8 bundles (with K2's packs where the
checkout has them), and the int8-loaded vocoder's q8 bundles in the
factored embedding (`sample_loop.set_emb("factored")`) and the composed one
(these two also at 256 streams over one block of 160), at the PLC path's
compacted drain, 64 streams over 3
conditioning blocks of 160 steps, one stream in each 8 draining all 480
steps, the others 400, 240, 80 or none, from seeded frame-network
conditioning and targets; and K4 (`plc_chain.plc_chain_kernel`, 20 calls) on
the demo PLC network at 256 and at 160 streams (clusters of 32 and of 16
streams), 4 steps, seeded states and inputs, 60 % of the steps masked in,
an eighth of the streams frozen. A call of the K3
wrapper includes its closed forms in PyTorch (`tf_precompute`), so each
kernel's own device time is read too, from torch.profiler over 3 calls. It
prints one JSON line {"label", "card", "ms": {...}}. Run the parent and the
change alternately (parent, change, change, parent) in one call; every
process reads the same seeded inputs.

With --trace (a checkout whose K3 is the teacher-forced form of
`csrc/masked_loop.cu`) it also builds a copy of that source whose K3 loop
reads `clock64()` in block 0 at each phase of a step, in thread 32 (a warp
that takes GRU-A tiles) and in thread 0 (a warp that runs GRU-B), into
`lpcnet_torch/kernels/build/trace/` (git-ignored), runs one bf16 launch of
the drain through it and prints the cycles a step spends in each phase:
GRU-A's product (thread 0: GRU-B's products), the block barrier, the gate
phase, the block barrier, the exchange's DSMEM stores, the cluster
barrier's arrive with what runs before its wait (GRU-B's update, the next
gate inputs' loads), and the wait. The kernel without the reads is the one
the port runs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

PHASES = ("GRU-A product (thread 0: GRU-B products)", "block barrier 1", "gate phase",
          "block barrier 2", "exchange stores", "arrive, GRU-B update, next loads",
          "cluster barrier wait")

# (anchor in csrc/masked_loop.cu's teacher-forced loop, text put in its place)
PROBES = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n__device__ unsigned long long g_trace[16];\n"),
    ("      const bool gru_b_warp = (warp & 3) == 0;\n"
     "      cluster.sync();   // every block runs and is set up before remote stores\n",
     "      const bool gru_b_warp = (warp & 3) == 0;\n"
     "      cluster.sync();   // every block runs and is set up before remote stores\n"
     "      unsigned long long tk = clock64();\n"
     "#define TR(i) if (blockIdx.x == 0 && (tid == 0 || tid == 32)) "
     "{ unsigned long long c_ = clock64(); g_trace[(tid ? 0 : 8) + i] += c_ - tk; tk = c_; }\n"),
    ("        if (j == total) break;\n        __syncthreads();\n",
     "        TR(0)\n        if (j == total) break;\n        __syncthreads();\n        TR(1)\n"),
    ("        __syncthreads();\n        send_slice(nxt);\n        // the cluster barrier:",
     "        TR(2) __syncthreads(); TR(3)\n        send_slice(nxt);\n        TR(4)\n"
     "        // the cluster barrier:"),
    ("        load_codes(k1, t1);\n"
     "        asm volatile(\"barrier.cluster.wait.acquire.aligned;\\n\" ::: \"memory\");\n",
     "        load_codes(k1, t1);\n        TR(5)\n"
     "        asm volatile(\"barrier.cluster.wait.acquire.aligned;\\n\" ::: \"memory\");\n"
     "        TR(6)\n"),
]
TRACE_API = """
extern "C" int trace_get(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(unsigned long long) * 16);
}
extern "C" int trace_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z));
}
"""


def _time(fn, reps, torch):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(fn, names, reps=3):
    """ms of device time a call spends in kernels whose name holds one of
    `names`, from torch.profiler over `reps` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    us = sum(dev(e) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and any(n in e.key for n in names))
    return us / 1e3 / reps


def drain_case(fused, cfg, dev, b=64, n=160, nblk=3, seed=53):
    """K3's drain-shaped arguments: (s0, cond_a, cond_b, lpc blocks, targets,
    counts); stream i drains rows[i % 8] steps of each block."""
    import numpy as np
    import torch

    from lpcnet_torch.models import lpcnet as M
    rs = np.random.RandomState(seed)
    r = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32)).to(dev)
    fs = M.init_frame_state(b, cfg, dev)
    cas, cbs, lpcs = [], [], []
    for _ in range(nblk + 2):
        fs, _, ca, cb, lpc = M.frame_network(fused, fs, r(b, 36) * 0.3, cfg)
        cas.append(ca), cbs.append(cb), lpcs.append(lpc)
    s0 = M.init_sample_state(b, cfg, dev)._replace(last_sig=r(b, 16) * 500,
                                                   deemph=r(b) * 200)
    rows = np.array([[n, n, n], [n, n, n // 2], [n, n // 2, 0], [n // 2, 0, 0],
                     [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0]], np.int32)[:, :nblk]
    counts = torch.from_numpy(rows[np.arange(b) % 8]).to(dev)
    stack = lambda xs: torch.stack(xs[-nblk:], dim=1).contiguous()
    return s0, stack(cas), stack(cbs), stack(lpcs), r(b, nblk * n) * 900, counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", nargs="?",
                    default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    ap.add_argument("--trace", action="store_true")
    ns = ap.parse_args(argv)
    root = os.path.abspath(ns.checkout)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from lpcnet_torch import api
    from lpcnet_torch.kernels import _build
    from lpcnet_torch.kernels import plc_chain as PC
    from lpcnet_torch.kernels import sample_loop as K
    from lpcnet_torch.models import plc as PM
    from lpcnet_torch.nn.quantized import quantize_fused

    if not torch.cuda.is_available():
        sys.exit("time_k3_k4_torch: CUDA is not available")
    _build.build_all(["sample_loop", "masked_loop", "plc_chain"])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = {}

    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    s0, ca, cb, lpc, tg, counts = drain_case(fused, cfg, dev)
    pack = getattr(K, "masked_kernel_weights", lambda kw: kw)
    k3_names = ("tf_kernel", "masked_loop_kernel")
    bundles = {"f32": K.kernel_weights(fused, cfg, dtype=torch.float32),
               "bf16": K.kernel_weights(fused, cfg),
               "q8": K.kernel_weights(quantize_fused(fused), cfg)}
    # the factored q8 embedding on the int8-loaded vocoder, and that model's
    # composed q8 bundle; these two also at 256 streams, one block of 160
    fq, _ = api.load_model(api.DEMO_MODEL_PATH, int8=True, device=dev)
    prev = K.set_emb("factored")
    try:
        bundles["q8 factored"] = K.kernel_weights(fq, cfg)
    finally:
        K.set_emb(prev)
    bundles["q8 composed, int8 model"] = K.kernel_weights(fq, cfg)
    wide = drain_case(fused, cfg, dev, b=256, nblk=1)
    for form, kw in bundles.items():
        kw = pack(kw)
        call = lambda: K.teacher_force_blocks_kernel(kw, s0, ca, cb, lpc, tg, counts, 160)
        ms[f"k3[{form}] B=64 3x160 call"] = _time(call, 10, torch)
        ms[f"k3[{form}] B=64 3x160 kernel"] = _kernel_ms(call, k3_names)
        if "int8" in form or "factored" in form:
            call = lambda: K.teacher_force_blocks_kernel(kw, *wide, 160)
            ms[f"k3[{form}] B=256 1x160 call"] = _time(call, 10, torch)
            ms[f"k3[{form}] B=256 1x160 kernel"] = _kernel_ms(call, k3_names)

    plc_params = api.load_plc_model(api.DEMO_PLC_MODEL_PATH, device=dev)
    cw = PC.plc_chain_weights(plc_params)
    for b in (256, 160):
        k = 4
        rs = np.random.RandomState(59)
        r = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32)).to(dev)
        masks = torch.from_numpy(rs.rand(b, k) < 0.6).to(dev)
        masks[: b // 8] = False
        args = (cw, torch.tanh(r(b, 256)), torch.tanh(r(b, 256)),
                r(b, k, PM.PLC_INPUT_SIZE) * 0.5, masks, k)
        call = lambda: PC.plc_chain_kernel(*args)
        ms[f"k4 B={b} K=4 call"] = _time(call, 20, torch)
        ms[f"k4 B={b} K=4 kernel"] = _kernel_ms(call, ("chain",))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": ns.label or root, "card": card, "ms": ms}), flush=True)
    if ns.trace:
        trace_k3(root, K, bundles["bf16"], (s0, ca, cb, lpc, tg, counts), card)


def trace_k3(root, K, kw, case, card):
    """One bf16 K3 launch on `case` through a copy of csrc/masked_loop.cu
    with clock reads; prints the cycles a step of cluster 0 spends in each
    phase."""
    import torch

    from lpcnet_torch.kernels import _build
    from lpcnet_torch.kernels import masked_loop as ML
    src = open(os.path.join(root, "lpcnet_torch/kernels/csrc/masked_loop.cu")).read()
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            sys.exit(f"time_k3_k4_torch: anchor not found once: {anchor!r}")
        src = src.replace(anchor, text)
    out_dir = os.path.join(root, "lpcnet_torch/kernels/build/trace")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "masked_loop_trace.cu"), os.path.join(out_dir, "libtrace_k3.so")
    with open(cu, "w") as fh:
        fh.write(src + TRACE_API)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", so, cu],
                   check=True, capture_output=True)
    kw = K.masked_kernel_weights(kw)
    s0, ca, cb, lpc, tg, counts = case
    real = K._masked_lib()
    lib = ctypes.CDLL(so)
    for name in ("lpcnet_masked_loop", "lpcnet_masked_loop_max_clusters",
                 "lpcnet_teacher_force"):
        getattr(lib, name).argtypes = getattr(real, name).argtypes
        getattr(lib, name).restype = ctypes.c_int
    K._MASKED_LIB = lib
    try:
        K.teacher_force_blocks_kernel(kw, s0, ca, cb, lpc, tg, counts, 160)
        torch.cuda.synchronize()
        lib.trace_reset()
        K.teacher_force_blocks_kernel(kw, s0, ca, cb, lpc, tg, counts, 160)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        lib.trace_get(buf)
    finally:
        K._MASKED_LIB = real
    dev = ca.device
    cfg = ML.tf_launch_config(counts.shape[0], 384, 16, 1, counts.shape[1],
                              K._max_clusters(dev, 1, 384, K.KIND_TF))
    steps = len(ML.tf_step_budget(counts.cpu(), cfg["streams"], 160)[1][0])
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    for who, base in (("thread 32 (GRU-A tiles)", 0), ("thread 0 (GRU-B)", 8)):
        cyc = [v / steps for v in buf[base:base + len(PHASES)]]
        print(f"K3[bf16] B={counts.shape[0]} 3x160: clusters of {cfg['cluster']} x "
              f"{cfg['units']} units, {cfg['streams']} streams, {cfg['smem']} bytes; "
              f"cluster 0 runs {steps} steps; cycles a step (clock64, block 0, {who}): "
              + ", ".join(f"{p} {c:.0f}" for p, c in zip(PHASES, cyc))
              + f"; total {sum(cyc):.0f}; SM clock {clocks}; card: {card}", flush=True)


if __name__ == "__main__":
    main()
