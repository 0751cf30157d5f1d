"""Cycles a step of the free-running sample loop (K1, csrc/masked_loop.cu's
cluster kernel in its free-running form), phase by phase, on one CUDA card:

    python tools/trace_k1_torch.py [--label NAME]

It builds two copies of csrc/masked_loop.cu into
`lpcnet_torch/kernels/build/trace/` (git-ignored), one nvcc each, at once:
"traced", whose K1 loop reads `clock64()` in block 0 (rank 0, which owns a
tail) at each phase of a step, in thread 0 (warp 0: the tree, the PCM and
the next codes) and thread 32 (a warp of GRU-A's product), and
"no_product", the same with the f32 GRU-A product's tile left out (its
sums read as zero; the PCM is then not the model's, the step's other work
the same). On the demo vocoder it runs one launch of each at B=4 and
B=1024 in f32 (the cluster kernel forced, `sample_loop._launch(...,
route="cluster")`) and bf16 at B=1024, and prints for each the ms a launch
(CUDA events over 5 launches) and the cycles a step spends in each phase,
with the card's name, power limit and top SM clock and the clusters of the f32
layouts the card holds at once (the kernel's occupancy query). The kernel
without the reads is the one the port runs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("warp 0: tree, PCM, codes / the others: GRU-A product", "codes cluster barrier",
          "gate phase", "block barrier", "slice exchange stores", "GRU-B parts (f32)",
          "operand cluster barrier", "GRU-B products", "block barrier", "GRU-B update",
          "block barrier", "node logits, tree levels 0-3", "end barrier")

# (anchor in csrc/masked_loop.cu, text put in its place)
PROBES = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n__device__ unsigned long long g_trace[64];\n"),
    ("  for (int t = 0; t <= n; ++t) {\n"
     "    // ---- warp 0: the tree and the PCM of step t-1, the codes of step t\n",
     "  unsigned long long tk = clock64();\n"
     "#define TR(i) if (FREE && blockIdx.x == 0 && (tid == 0 || tid == 32)) "
     "{ unsigned long long c_ = clock64(); g_trace[(tid ? 0 : 32) + i] += c_ - tk; tk = c_; }\n"
     "  for (int t = 0; t <= n; ++t) {\n"
     "    // ---- warp 0: the tree and the PCM of step t-1, the codes of step t\n"),
    ("    if constexpr (FREE) cluster.sync(); else __syncthreads();\n",
     "    TR(0) if constexpr (FREE) cluster.sync(); else __syncthreads(); TR(1)\n"),
    ("    __syncthreads();\n    send_slice(nxt);\n",
     "    TR(2) __syncthreads(); TR(3)\n    send_slice(nxt); TR(4)\n"),
    ("    if constexpr (FREE && !F::MMA) send_b_parts(nxt);\n",
     "    if constexpr (FREE && !F::MMA) send_b_parts(nxt);\n    TR(5)\n"),
    ("    // block's product of this step done before any slice was sent)\n"
     "    cluster.sync();\n",
     "    // block's product of this step done before any slice was sent)\n"
     "    cluster.sync(); TR(6)\n"),
    ("    __syncthreads();\n\n    // ---- GRU-B's update, thread (tail stream, unit)\n",
     "    TR(7) __syncthreads(); TR(8)\n\n    // ---- GRU-B's update, thread (tail stream, unit)\n"),
    ("    __syncthreads();\n\n    // ---- the dual-FC logits of the nodes the tree visits",
     "    TR(9) __syncthreads(); TR(10)\n\n    // ---- the dual-FC logits of the nodes the tree visits"),
    ("      }\n    }\n    __syncthreads();\n  }\n\n"
     "  // ---- the carried state: each rank its own h_a units, the tail's owner",
     "      }\n    }\n    TR(11) __syncthreads(); TR(12)\n  }\n\n"
     "  // ---- the carried state: each rank its own h_a units, the tail's owner"),
]
# the f32 product's tile left out: its sums read as zero
NO_PRODUCT = [("  float a[32];                                   // a[4 s + c]\n",
               "  if (4 * g + (lane & 3) < ncol) out[(lane >> 2) * ldo + 4 * g + (lane & 3)] = 0.f;\n"
               "  if (ncol > 0) return;\n  float a[32];\n")]
TRACE_API = """
extern "C" int trace_get(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(unsigned long long) * 64);
}
extern "C" int trace_reset() {
  unsigned long long z[64] = {0};
  return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z));
}
"""


def _smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=None)
    ns = ap.parse_args(argv)
    import numpy as np
    import torch

    from lpcnet_torch import api
    from lpcnet_torch.kernels import _build
    from lpcnet_torch.kernels import masked_loop as ML
    from lpcnet_torch.kernels import sample_loop as K
    from lpcnet_torch.models import lpcnet as M

    if not torch.cuda.is_available():
        sys.exit("trace_k1_torch: CUDA is not available")
    src = (_build.CSRC / "masked_loop.cu").read_text()
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            sys.exit(f"trace_k1_torch: anchor not found once: {anchor!r}")
        src = src.replace(anchor, text)
    out_dir = os.path.join(ROOT, "lpcnet_torch/kernels/build/trace")
    os.makedirs(out_dir, exist_ok=True)
    builds = {}
    for name, extra in (("traced", []), ("no_product", NO_PRODUCT)):
        text = src
        for anchor, repl in extra:
            if text.count(anchor) != 1:
                sys.exit(f"trace_k1_torch: anchor not found once: {anchor!r}")
            text = text.replace(anchor, repl)
        cu, so = os.path.join(out_dir, f"k1_{name}.cu"), os.path.join(out_dir, f"libk1_{name}.so")
        with open(cu, "w") as fh:
            fh.write(text + TRACE_API)
        builds[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    dev = torch.device("cuda")
    card, clock = _smi("name,power.limit"), _smi("clocks.max.sm")
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    na, nb = cfg.rnn_units1, cfg.rnn_units2
    real = K._masked_lib()
    held = {nt: K._max_clusters(dev, 0, na, K.KIND_FREE)(
        nt, ML.masked_smem_bytes(0, na, nb, nt, True, False, free=True)) for nt in (1, 2, 4, 5)}
    print(json.dumps({"label": ns.label or ROOT, "card": card, "max_sm_clock": clock,
                      "f32_clusters_of_16_held_by_streams": {8 * k: v for k, v in held.items()}}),
          flush=True)
    bundles = {"f32": K.masked_kernel_weights(K.kernel_weights(fused, cfg, dtype=torch.float32)),
               "bf16": K.masked_kernel_weights(K.kernel_weights(fused, cfg))}
    for name, (proc, so) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"trace_k1_torch: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn in ("lpcnet_masked_loop", "lpcnet_masked_loop_max_clusters", "lpcnet_teacher_force"):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        K._MASKED_LIB = lib
        try:
            for form, b in (("f32", 4), ("f32", 1024), ("bf16", 1024)):
                if name == "no_product" and form != "f32":
                    continue
                kw = bundles[form]
                rs = np.random.RandomState(1)
                feats = torch.from_numpy((rs.normal(size=(3, b, 36)) * 0.3).astype(np.float32)).to(dev)
                fs = M.init_frame_state(b, cfg, dev)
                for k in range(3):
                    fs, _, ca, cb, lpc = M.frame_network(fused, fs, feats[k], cfg)
                ca, cb, lpc = ca.contiguous(), cb.contiguous(), lpc.contiguous()
                s0 = M.init_sample_state(b, cfg, dev)
                run = lambda: K._launch(kw, s0, ca, cb, lpc, 160, route="cluster")
                run()
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(5):
                    run()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / 5
                lib.trace_reset()
                run()
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 64)()
                lib.trace_get(buf)
                c = ML.free_launch_config(b, na, nb, ML.FORMS[form],
                                          K._max_clusters(dev, ML.FORMS[form], na, K.KIND_FREE))
                for who, base in (("thread 32", 0), ("thread 0", 32)):
                    cyc = [v / 160 for v in buf[base:base + len(PHASES)]]
                    print(f"K1[{form}] {name} B={b} (S={c['streams']}, clusters of {c['cluster']}, "
                          f"{c['clusters']} in {c['waves']} wave(s)): {ms:.4f} ms a launch; cycles a "
                          f"step, block 0, {who}: " + ", ".join(
                              f"{p} {x:.0f}" for p, x in zip(PHASES, cyc))
                          + f"; total {sum(cyc):.0f}; max SM clock {clock}; card: {card}", flush=True)
        finally:
            K._MASKED_LIB = real


if __name__ == "__main__":
    main()
