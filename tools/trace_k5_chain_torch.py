"""Where a step of K5's backward chain and of its resident forward goes, on
one CUDA card:

    python tools/trace_k5_chain_torch.py [--units 384]

It times the backward's three phases at the training shape (B=128,
T=2400): the gate pass alone (`gru_train.gate_pass_kernel`), the backward
of a graph whose weights ask for no gradient (gate pass and chain), and
the whole backward (the rest is dWr and the reductions). Then it builds a
copy of `csrc/gru_train.cu` whose chain kernel reads `clock64()` in thread
0 of block 0 at each phase of a step (into `lpcnet_torch/kernels/build/
trace/`, git-ignored), runs one backward through it and prints the cycles
a step spends in each phase: the step's arithmetic and stores, the first
block barrier, the broadcast of dzrec over distributed shared memory, the
cluster barrier, the dh product, the second block barrier, the sum of the
k parts. The same copy's resident forward (`gru_fwd_chain_kernel`, where
the width has one) reads `clock64()` likewise, and one forward through it
gives its phases: the gate-input loads issued and the product, the block
barrier, the k-part sum and the gate arithmetic, the exchange of the new h
(shuffles and the 16-byte stores to every block), the cluster barrier's
arrive with the store of hs, and its wait; the forward is also timed
alone (CUDA events). The kernels without the reads are the ones the port
runs.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("step arithmetic and stores", "block barrier 1", "dzrec broadcast",
          "cluster barrier", "dh product", "block barrier 2", "k-part sum")
FWD_PHASES = ("loads issued and product", "block barrier", "k-part sum and gates",
              "exchange", "barrier arrive and hs store", "barrier wait")

# (anchor in the chain kernel, text put in its place): the clock reads
PROBES = [
    ("namespace {\n\ntypedef __nv_bfloat16 bf16;",
     "__device__ unsigned long long g_trace[16];\nnamespace {\n\ntypedef __nv_bfloat16 bf16;"),
    ("    const Fac f2 = load(t - 2);",
     "    unsigned long long tk = clock64();\n"
     "#define TR(i) if (blockIdx.x == 0 && tid == 0) "
     "{ unsigned long long c_ = clock64(); g_trace[i] += c_ - tk; tk = c_; }\n"
     "    const Fac f2 = load(t - 2);"),
    ("      zrow[2 * n + u] = __float2bfloat16_rn(dzv);\n    }\n    __syncthreads();",
     "      zrow[2 * n + u] = __float2bfloat16_rn(dzv);\n    }\n    TR(0) __syncthreads(); TR(1)"),
    ("    // dzrec is complete in every block; the buffer alternates with t, so no",
     "    TR(2)\n    // dzrec is complete in every block; the buffer alternates with t, so no"),
    ("    // block a step ahead overwrites what another still reads\n    step_barrier(cluster, C);",
     "    // block a step ahead overwrites what another still reads\n"
     "    step_barrier(cluster, C); TR(3)"),
    ("      pp[U + 8] = acc[nt][3];\n    }\n    __syncthreads();",
     "      pp[U + 8] = acc[nt][3];\n    }\n    TR(4) __syncthreads(); TR(5)"),
    ("    f0 = f1;\n    f1 = f2;", "    f0 = f1;\n    f1 = f2;\n    TR(6)"),
    # the resident forward, into g_trace[8 + i]
    ("    const Gin g2 = load(t + 2);",
     "    unsigned long long tf_ = clock64();\n"
     "#define TRF(i) if (blockIdx.x == 0 && tid == 0) "
     "{ unsigned long long c_ = clock64(); g_trace[8 + i] += c_ - tf_; tf_ = c_; }\n"
     "    const Gin g2 = load(t + 2);"),
    ("      }\n    }\n    __syncthreads();\n    float zr[3];",
     "      }\n    }\n    TRF(0) __syncthreads(); TRF(1)\n    float zr[3];"),
    ("    // the new operand: lanes 8j .. 8j+7 hold",
     "    TRF(2)\n    // the new operand: lanes 8j .. 8j+7 hold"),
    ("map_shared_rank(nxt, c) + woff) = v;\n",
     "map_shared_rank(nxt, c) + woff) = v;\n    TRF(3)\n"),
    ("    g1 = g2;\n    asm volatile(\"barrier.cluster.wait.acquire.aligned;\\n\" ::: \"memory\");\n",
     "    g1 = g2;\n    TRF(4)\n"
     "    asm volatile(\"barrier.cluster.wait.acquire.aligned;\\n\" ::: \"memory\");\n    TRF(5)\n"),
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
    ap.add_argument("--units", type=int, default=384)
    ns = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from lpcnet_torch.kernels import _build
    from lpcnet_torch.kernels import gru_train as G

    if not torch.cuda.is_available():
        sys.exit("trace_k5_chain_torch: CUDA is not available")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    n, b, t = ns.units, 128, 2400
    rs = np.random.RandomState(7)
    f = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32)).to(dev)
    kernel, wr0 = f(512, 3 * n) * 0.05, f(n, 3 * n) * float(0.8 / np.sqrt(n))
    bias, x, h0, w = f(2, 3 * n) * 0.1, f(b, t, 512), f(b, n) * 0.3, f(b, t, n)
    wr = wr0.clone().requires_grad_(True)
    br = bias[1].clone().requires_grad_(True)
    gi = G.gate_input({"kernel": kernel, "bias": bias}, x).requires_grad_(True)
    hs, ht = G.gru_recurrence(wr, br, gi, h0)
    hs_nw, ht_nw = G.gru_recurrence(wr.detach(), br.detach(), gi, h0)
    dht = torch.zeros_like(ht)
    whole = lambda: torch.autograd.grad((hs, ht), (wr, br, gi), (w, dht), retain_graph=True)
    whole_ms = _time(whole, 3, torch)
    no_w_ms = _time(lambda: torch.autograd.grad((hs_nw, ht_nw), (gi,), (w, dht),
                                                retain_graph=True), 3, torch)
    with torch.no_grad():
        gate_ms = _time(lambda: G.gate_pass_kernel(wr, br, gi, h0, hs), 3, torch)
        fwd = lambda: G.gru_recurrence(wr, br, gi, h0)
        fwd_ms = _time(fwd, 3, torch)
    cfg = G.bwd_launch_config(b, n, G._max_clusters(dev, n))
    resident = G.forward_route(n) == "resident"
    if resident:
        fcfg = G.fwd_launch_config(b, n, G._max_clusters(dev, n, "fwd"))

    src = open(os.path.join(ROOT, "lpcnet_torch/kernels/csrc/gru_train.cu")).read()
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            sys.exit(f"trace_k5_chain_torch: anchor not found once: {anchor!r}")
        src = src.replace(anchor, text)
    out_dir = os.path.join(ROOT, "lpcnet_torch/kernels/build/trace")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "gru_train_trace.cu"), os.path.join(out_dir, "libtrace.so")
    with open(cu, "w") as fh:
        fh.write(src + TRACE_API)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu], check=True,
                   capture_output=True)
    lib, real = ctypes.CDLL(so), G._lib()
    for name in ("lpcnet_gru_train_fwd", "lpcnet_gru_train_fwd_warp", "lpcnet_gru_train_bwd",
                 "lpcnet_gru_gate_pass", "lpcnet_gru_max_clusters",
                 "lpcnet_gru_train_fwd_chain"):
        getattr(lib, name).argtypes = getattr(real, name).argtypes
        getattr(lib, name).restype = ctypes.c_int
    G._LIB = lib
    try:
        whole()
        torch.cuda.synchronize()
        lib.trace_reset()
        whole()
        torch.cuda.synchronize()
        with torch.no_grad():
            fwd()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        lib.trace_get(buf)
    finally:
        G._LIB = real
    cycles = [v / t for v in buf[:len(PHASES)]]
    fcycles = [v / t for v in buf[8:8 + len(FWD_PHASES)]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"K5 bwd[{n}] B={b} T={t}: whole {whole_ms:.3f} ms = gate pass {gate_ms:.3f} "
          f"+ chain {no_w_ms - gate_ms:.3f} + dWr and reductions {whole_ms - no_w_ms:.3f} "
          f"(CUDA events); chain: clusters of {cfg['cluster']} x {cfg['units']} units, "
          f"{cfg['streams']} streams, Wr {'resident' if cfg['resident'] else 'from L2'}; "
          "cycles a step (clock64, block 0, thread 0): "
          + ", ".join(f"{p} {c:.0f}" for p, c in zip(PHASES, cycles))
          + f"; total {sum(cycles):.0f}; card: {smi}", flush=True)
    if resident:
        print(f"K5 fwd[{n}] B={b} T={t}: {fwd_ms:.3f} ms (CUDA events); "
              f"gru_fwd_chain_kernel, clusters of {fcfg['cluster']} x {fcfg['units']} "
              f"units, {fcfg['streams']} streams, Wr resident, {fcfg['smem']} bytes; "
              "cycles a step (clock64, block 0, thread 0): "
              + ", ".join(f"{p} {c:.0f}" for p, c in zip(FWD_PHASES, fcycles))
              + f"; total {sum(fcycles):.0f}; card: {smi}", flush=True)
    else:
        print(f"K5 fwd[{n}] B={b} T={t}: {fwd_ms:.3f} ms (CUDA events), "
              f"route {G.forward_route(n)}: no resident forward to trace; card: {smi}",
              flush=True)


if __name__ == "__main__":
    main()
