"""Cycles a step of the cluster sample-loop kernel (csrc/masked_loop.cu) in
the q8 operand forms, composed and factored, phase by phase, on one CUDA
card, for the checkout at CHECKOUT (default: this repository):

    python tools/trace_fact_torch.py [CHECKOUT] [--label NAME]

It builds a copy of the checkout's csrc/masked_loop.cu with `clock64()`
probes into that checkout's `lpcnet_torch/kernels/build/trace/`
(git-ignored): block 0 (rank 0 of cluster 0) reads the clock at each phase
of a step in thread 0 (warp 0: the tree, the PCM and the codes in K1 and
K2; GRU-B's products and update in K3) and thread 32 (a warp of GRU-A's
product). The probes follow the kernel's design: PROBES holds one set for
each design of the factored form ("first": g gathered after the codes'
barrier, its product a phase of its own; "fused": its product fused with
the gate phase, g delivered with the codes in K1 and K2 and gathered in the
barrier's window a step ahead in K3), and the tool takes the set whose
anchors the source holds. On the demo vocoder
loaded int8 (`api.load_model(int8=True)`) it runs, each in the composed q8
form and the factored one on the same inputs: K1 at B=1024, n=160; K2 at
B=64, n=80 (the PLC's compacted section, the sampler on); K3 at B=64 over
3 x 160 (the causal drain's counts, `chip_smoke.tf_case`) and at B=256 over
one block of 160. For each it prints the ms a launch (CUDA events over 5
launches of the traced build), the launch's shape, and the cycles a step
(block 0's steps) each probed phase takes, with the card's name, power
limit and top SM clock. Run the parent and the change in one call to
compare designs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

# the probe macros: TR(i) in K1's and K2's loop (slots 0-31), TR3(i) in
# K3's (32-63), TRG(i) in the fused gate phase (64-79); slot i of thread 32
# at i, of thread 0 at 128 + i; K3's steps counted at 255
HEAD = ("namespace cg = cooperative_groups;\n",
        "namespace cg = cooperative_groups;\n__device__ unsigned long long g_trace[256];\n"
        "#define TRACE_AT(i, tk) if (blockIdx.x == 0 && (tid == 0 || tid == 32)) "
        "{ unsigned long long c_ = clock64(); g_trace[(tid ? 0 : 128) + (i)] += c_ - tk; "
        "tk = c_; }\n")
LOOP = ("  for (int t = 0; t <= n; ++t) {\n"
        "    // ---- warp 0: the tree and the PCM of step t-1, the codes of step t\n")
LOOP_TRACED = ("  unsigned long long tk = clock64();\n#define TR(i) TRACE_AT(i, tk)\n" + LOOP)
TF_LOOP = "      for (int j = 0;; ++j) {\n        const OT* cur = hop + (j & 1) * hstride;\n"
TF_LOOP_TRACED = ("      unsigned long long tk3 = clock64();\n"
                  "#define TR3(i) TRACE_AT(32 + (i), tk3)\n" + TF_LOOP)
WAIT = '        asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");\n'
BAR96 = '          asm volatile("bar.sync 1, 96;\\n" ::: "memory");\n        }\n'
STEP3 = "if (blockIdx.x == 0 && tid == 0) g_trace[255] += 1;"
WINDOW = ("          if (!FUSED) {\n            asm volatile(\"bar.sync 2, 288;\\n\" ::: \"memory\");\n"
          "            fact_array(pt9, 288);\n          }\n        }\n")
GATE_PHASES = ("loads issued", "g's product", "epilogue (gates)")

# design -> (K1/K2 phases, K3 phases, [(anchor, text put in its place)])
PROBES = {
    "first": (
        ("warp 0: tree, PCM, codes / the others: GRU-A product", "codes barrier",
         "gather g", "block barrier", "g's product", "block barrier", "gate phase",
         "block barrier", "slice exchange stores", "operand cluster barrier",
         "GRU-B products", "block barrier", "GRU-B update", "block barrier",
         "node logits, tree levels 0-3", "end barrier"),
        ("GRU-A product + g's product / warp 0: GRU-B products of step j-1",
         "block barrier", "gate phase", "block barrier", "slice exchange stores",
         "GRU-B update (warps 0, 4, 8)", "next step's gate inputs and codes",
         "gather g of the next step", "cluster barrier wait", "block barrier (g)"),
        [HEAD, (LOOP, LOOP_TRACED),
         ("    if constexpr (FREE) cluster.sync(); else __syncthreads();\n",
          "    TR(0) if constexpr (FREE) cluster.sync(); else __syncthreads(); TR(1)\n"),
         ("      gather_g([&](int s, int r) { return code[CW * s + r]; }, is_live);\n"
          "      __syncthreads();\n      emb_product(tid, K2_THREADS);\n      __syncthreads();\n",
          "      gather_g([&](int s, int r) { return code[CW * s + r]; }, is_live); TR(2)\n"
          "      __syncthreads(); TR(3)\n      emb_product(tid, K2_THREADS); TR(4)\n"
          "      __syncthreads(); TR(5)\n"),
         ("    __syncthreads();\n    send_slice(nxt);\n",
          "    TR(6) __syncthreads(); TR(7)\n    send_slice(nxt); TR(8)\n"),
         ("    // block's product of this step done before any slice was sent)\n"
          "    cluster.sync();\n",
          "    // block's product of this step done before any slice was sent)\n"
          "    cluster.sync(); TR(9)\n"),
         ("    __syncthreads();\n\n    // ---- GRU-B's update, thread (tail stream, unit)\n",
          "    TR(10) __syncthreads(); TR(11)\n\n    // ---- GRU-B's update, thread (tail stream, unit)\n"),
         ("    __syncthreads();\n\n    // ---- the dual-FC logits of the nodes the tree visits",
          "    TR(12) __syncthreads(); TR(13)\n\n    // ---- the dual-FC logits of the nodes the tree visits"),
         ("      }\n    }\n    __syncthreads();\n  }\n\n"
          "  // ---- the carried state: each rank its own h_a units, the tail's owner",
          "      }\n    }\n    TR(14) __syncthreads(); TR(15)\n  }\n\n"
          "  // ---- the carried state: each rank its own h_a units, the tail's owner"),
         (TF_LOOP, TF_LOOP_TRACED),
         ("        if (j == total) break;\n        __syncthreads();\n",
          f"        TR3(0) if (j == total) break;\n        __syncthreads(); TR3(1) {STEP3}\n"),
         ("        __syncthreads();\n        send_slice(nxt);\n",
          "        TR3(2) __syncthreads(); TR3(3)\n        send_slice(nxt); TR3(4)\n"),
         (BAR96, BAR96 + "        TR3(5)\n"),
         ("        load_codes(k1, t1);\n        if (fact) gather_g(tf_code(k, t), tf_live(k, t));\n"
          + WAIT,
          "        load_codes(k1, t1); TR3(6)\n"
          "        if (fact) gather_g(tf_code(k, t), tf_live(k, t)); TR3(7)\n" + WAIT
          + "        TR3(8)\n"),
         ("        if (fact) __syncthreads();\n      }\n",
          "        if (fact) __syncthreads(); TR3(9)\n      }\n")]),
    "fused": (
        ("warp 0: tree, PCM, codes / the others: GRU-A product",
         "warps 0, 4, 8: rows g delivered with the codes", "codes barrier",
         "gate phase (factored: with g's product)", "block barrier", "slice exchange stores",
         "operand cluster barrier", "GRU-B products", "block barrier", "GRU-B update",
         "block barrier", "node logits, tree levels 0-3", "end barrier"),
        ("GRU-A product / warp 0: GRU-B products of step j-1", "block barrier",
         "gate phase (factored: with g's product)", "block barrier", "slice exchange stores",
         "arrive, GRU-B update (warps 0, 4, 8)",
         "rows g of step j+1 (the nine; S <= 16: and their product)",
         "next step's gate inputs and codes", "cluster barrier wait"),
        [HEAD, (LOOP, LOOP_TRACED),
         ("    // ---- the factored embedding: once warp 0 has this rank's codes of\n",
          "    TR(0)\n    // ---- the factored embedding: once warp 0 has this rank's codes of\n"),
         ("    if (t == n) break;\n    // free-running: every block's codes of step t have arrived\n"
          "    if constexpr (FREE) cluster.sync(); else __syncthreads();\n",
          "    TR(1) if (t == n) break;\n"
          "    if constexpr (FREE) cluster.sync(); else __syncthreads(); TR(2)\n"),
         ("    __syncthreads();\n    send_slice(nxt);\n",
          "    TR(3) __syncthreads(); TR(4)\n    send_slice(nxt); TR(5)\n"),
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
         (TF_LOOP, TF_LOOP_TRACED),
         ("        if (j == total) break;\n        __syncthreads();\n",
          f"        TR3(0) if (j == total) break;\n        __syncthreads(); TR3(1) {STEP3}\n"),
         ("        __syncthreads();\n        send_slice(nxt);\n",
          "        TR3(2) __syncthreads(); TR3(3)\n        send_slice(nxt); TR3(4)\n"),
         (BAR96, BAR96 + "        TR3(5)\n"),
         (WINDOW, WINDOW + "        TR3(6)\n"),
         ("      for (int task = warp; task < ntu * NGS; task += K2_WARPS) {\n",
          "      unsigned long long tg = clock64();\n#define TRG(i) TRACE_AT(64 + (i), tg)\n"
          "      for (int task = warp; task < ntu * NGS; task += K2_WARPS) {\n"),
         ("        if (p.res_f) fact_product(wf_s, ut, nt0, acc); else fact_product(wf_g, ut, nt0, acc);\n"
          "#pragma unroll\n        for (int i = 0; i < TPW; ++i) {\n          if (i >= ntt) continue;\n",
          "        TRG(0) if (p.res_f) fact_product(wf_s, ut, nt0, acc); "
          "else fact_product(wf_g, ut, nt0, acc); TRG(1)\n"
          "#pragma unroll\n        for (int i = 0; i < TPW; ++i) {\n          if (i >= ntt) continue;\n"),
         ("            nxt[s * L.ldx + u] = OpT<FORM>::of(h);\n          }\n        }\n      }\n    }\n  };\n",
          "            nxt[s * L.ldx + u] = OpT<FORM>::of(h);\n          }\n        }\n        TRG(2)\n"
          "      }\n    }\n  };\n"),
         ("        load_codes(k1, t1);\n" + WAIT,
          "        load_codes(k1, t1); TR3(7)\n" + WAIT + "        TR3(8)\n")]),
}
TRACE_API = """
extern "C" int trace_get(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(unsigned long long) * 256);
}
extern "C" int trace_reset() {
  unsigned long long z[256] = {0};
  return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z));
}
"""


def _smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def traced_source(src):
    """(design, the source with that design's probes)."""
    for design, (_, _, probes) in PROBES.items():
        if all(src.count(a) == 1 for a, _ in probes):
            for anchor, text in probes:
                src = src.replace(anchor, text)
            return design, src
    sys.exit("trace_fact_torch: no probe set's anchors are all in the source once")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", nargs="?",
                    default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    ns = ap.parse_args(argv)
    root = os.path.abspath(ns.checkout)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as CS
    from lpcnet_torch import api
    from lpcnet_torch.kernels import _build
    from lpcnet_torch.kernels import sample_loop as K
    from lpcnet_torch.models import lpcnet as M

    if not torch.cuda.is_available():
        sys.exit("trace_fact_torch: CUDA is not available")
    design, src = traced_source((_build.CSRC / "masked_loop.cu").read_text())
    out_dir = os.path.join(root, "lpcnet_torch/kernels/build/trace")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "fact_traced.cu"), os.path.join(out_dir, "libfact_traced.so")
    with open(cu, "w") as fh:
        fh.write(src + TRACE_API)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"trace_fact_torch: nvcc failed:\n{proc.stdout}{proc.stderr}")
    dev = torch.device("cuda")
    card, clock = _smi("name,power.limit"), _smi("clocks.max.sm")
    real = K._masked_lib()
    lib = ctypes.CDLL(so)
    for fn in ("lpcnet_masked_loop", "lpcnet_masked_loop_max_clusters", "lpcnet_teacher_force"):
        getattr(lib, fn).argtypes = getattr(real, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    fq, cfg, comp, fact = CS.q8_bundles(dev)
    na, nb = cfg.rnn_units1, cfg.rnn_units2
    print(json.dumps({"label": ns.label or root, "design": design, "card": card,
                      "max_sm_clock": clock}), flush=True)
    k1_phases, k3_phases, _ = PROBES[design]
    cases = []
    ca, cb, lpc = CS.conditioning(fq, cfg, 1024, dev)
    s0 = M.init_sample_state(1024, cfg, dev)
    cases.append(("K1", 1024, "160 steps", "free", 1, 160,
                  lambda kw: K.synthesize_frame_kernel(kw, s0, ca, cb, lpc)))
    ca2, cb2, lpc2 = CS.conditioning(fq, cfg, 64, dev)
    s2 = M.init_sample_state(64, cfg, dev)
    tg, tf, adv = CS.k2_masks(64, 80, dev, CS.SEED + 134, all_tf=False)
    cases.append(("K2", 64, "80 steps", "masked", 1, 80,
                  lambda kw: K.synthesize_frame_masked_kernel(kw, s2, ca2, cb2, lpc2, tg, tf,
                                                              adv, 80, True)))
    for b, nblk in ((64, 3), (256, 1)):
        st, ca3, cb3, lpc3, tg3, counts = CS.tf_case(fq, cfg, b, 160, nblk, dev, CS.SEED + 23)
        codes, _ = K.tf_codes(st, lpc3, tg3, counts, 160)
        cases.append(("K3", b, f"{nblk} x 160", "tf", nblk, None,
                      lambda kw, a=(st, ca3, cb3, counts, codes): K.tf_launch(kw, *a, 160)))
    K._MASKED_LIB = lib
    try:
        for name, b, shape, kind, nblk, steps, run in cases:
            for form, kw in (("q8 composed", comp), ("q8 factored", fact)):
                run(kw)
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(5):
                    run(kw)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / 5
                lib.trace_reset()
                run(kw)
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 256)()
                lib.trace_get(buf)
                phases, base = (k3_phases, 32) if kind == "tf" else (k1_phases, 0)
                n_steps = buf[255] if kind == "tf" else steps
                layout = CS.fact_layout(kind, b, cfg, dev, nblk) if form.endswith(
                    "factored") else "composed"
                for who, off in (("thread 32", 0), ("thread 0", 128)):
                    cyc = [v / max(n_steps, 1)
                           for v in buf[off + base:off + base + len(phases)]]
                    gate = [v / max(n_steps, 1) for v in buf[off + 64:off + 64 + len(GATE_PHASES)]]
                    split = ("; of the gate phase: " + ", ".join(
                        f"{p} {x:.0f}" for p, x in zip(GATE_PHASES, gate))) if any(gate) else ""
                    print(f"{name}[{form}] B={b}, {shape} ({layout}): {ms:.4f} ms a launch; "
                          f"cycles a step ({n_steps} steps), block 0, {who}: " + ", ".join(
                              f"{p} {x:.0f}" for p, x in zip(phases, cyc))
                          + f"; total {sum(cyc):.0f}{split}; design {design}; max SM clock "
                          f"{clock}; card: {card}", flush=True)
    finally:
        K._MASKED_LIB = real


if __name__ == "__main__":
    main()
