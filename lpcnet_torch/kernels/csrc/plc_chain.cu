// K4: K masked steps of the PLC feature-prediction network in one launch.
//
// Replaces the TPU kernel lpcnet_tpu/kernels/plc_chain.py::_chain_kernel
// (plc_chain_pallas). A step is dense n_in -> nd with tanh, a reset-after
// GRU of n1 units, one of n2 units, and a linear dense n2 -> n_out
// (57 -> 128 -> 256 -> 256 -> 20 in the shipped network), all in float32.
// A stream whose mask is 0 at a step keeps both GRU states; the step's raw
// output (from the candidate states) is written all the same, so the caller
// can choose per stream. The states after every step and every step's output
// go out; the +0.1 boost of the last feature stays with the caller.
//
// What bounds it on an H100: the K dependent steps, each four matrix-vector
// products that sweep 2.8 MB of float32 weights. The arithmetic (0.70 M
// multiply-adds a step and stream) and the bytes (the weights once, 10 KB a
// stream) are microseconds at the card's peaks; the weights stay in the 50 MB
// L2 and every block streams them from there once a step.
//
// What the design does about it: streams are independent, so a block owns CBT
// streams for all K steps (no grid-wide sync, one launch). CBT = 2 gives 128
// blocks at 256 streams, one for nearly every SM; each weight a block reads
// serves both of its streams. In a GRU thread u owns unit u and its three
// gate columns, input and recurrent part apart as the reset gate needs, so it
// forms the new h[u] with no exchange; a warp reads consecutive columns, so
// the loads coalesce. States, the dense activations and the inputs stay in
// shared memory. Plain FMAs in float32: no tensor cores, no TF32, so the
// result is within rounding of the plain PyTorch version. The TPU version's
// lane padding (57 -> 64, 20 -> 128) and its 256-stream tile are gone.

#include <cuda_runtime.h>

#define CBT 2           // streams per block
#define CNT 256         // threads per block

struct ChainArgs {
  int batch, k_steps, n_in, nd, n1, n2, n_out;
  const float* d1_w; const float* d1_b;          // [n_in, nd], [nd]
  const float* g1_in; const float* g1_rec;       // [nd, 3n1], [n1, 3n1]
  const float* g1_b;                             // [2, 3n1]
  const float* g2_in; const float* g2_rec;       // [n1, 3n2], [n2, 3n2]
  const float* g2_b;                             // [2, 3n2]
  const float* out_w; const float* out_b;        // [n2, n_out], [n_out]
  const float* inputs;                           // [B, K, n_in]
  const int* masks;                              // [B, K]
  const float* h1_in; const float* h2_in;        // [B, n1], [B, n2]
  float* h1_seq; float* h2_seq; float* outs;     // [B, K, n1], [B, K, n2], [B, K, n_out]
};

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// y[s][o] = act(x[s] . w[:, o] + b[o]) for the block's streams
template <bool TANH>
__device__ __forceinline__ void dense(const float* w, const float* b, int nx, int ny,
                                      const float* x, float* y, int tid) {
  for (int o = tid; o < CBT * ny; o += CNT) {
    const int s = o / ny, c = o % ny;
    float acc = 0.f;
    for (int k = 0; k < nx; ++k) acc = fmaf(x[s * nx + k], w[(size_t)k * ny + c], acc);
    acc += b[c];
    y[o] = TANH ? tanhf(acc) : acc;
  }
}

// one reset-after GRU step (gates z, r, h): hn = GRU(x, h) for the block's
// streams; thread u owns unit u
__device__ __forceinline__ void gru_step(const float* w_in, const float* w_rec, const float* bias,
                                         int nx, int n, const float* x, const float* h,
                                         float* hn, int tid) {
  const int n3 = 3 * n;
  for (int u = tid; u < n; u += CNT) {
    float gi[CBT][3], gr[CBT][3];
#pragma unroll
    for (int s = 0; s < CBT; ++s)
      gi[s][0] = gi[s][1] = gi[s][2] = gr[s][0] = gr[s][1] = gr[s][2] = 0.f;
    for (int k = 0; k < nx; ++k) {
      const float* row = w_in + (size_t)k * n3 + u;
      const float w0 = row[0], w1 = row[n], w2 = row[2 * n];
#pragma unroll
      for (int s = 0; s < CBT; ++s) {
        const float v = x[s * nx + k];
        gi[s][0] = fmaf(v, w0, gi[s][0]);
        gi[s][1] = fmaf(v, w1, gi[s][1]);
        gi[s][2] = fmaf(v, w2, gi[s][2]);
      }
    }
    for (int k = 0; k < n; ++k) {
      const float* row = w_rec + (size_t)k * n3 + u;
      const float w0 = row[0], w1 = row[n], w2 = row[2 * n];
#pragma unroll
      for (int s = 0; s < CBT; ++s) {
        const float v = h[s * n + k];
        gr[s][0] = fmaf(v, w0, gr[s][0]);
        gr[s][1] = fmaf(v, w1, gr[s][1]);
        gr[s][2] = fmaf(v, w2, gr[s][2]);
      }
    }
#pragma unroll
    for (int s = 0; s < CBT; ++s) {
      const float z = sigmoidf_((gi[s][0] + bias[u]) + (gr[s][0] + bias[n3 + u]));
      const float r = sigmoidf_((gi[s][1] + bias[n + u]) + (gr[s][1] + bias[n3 + n + u]));
      const float hc = tanhf((gi[s][2] + bias[2 * n + u]) + r * (gr[s][2] + bias[n3 + 2 * n + u]));
      const float h0 = h[s * n + u];
      hn[s * n + u] = z * h0 + (1.f - z) * hc;
    }
  }
}

__global__ void __launch_bounds__(CNT) chain_kernel(ChainArgs p) {
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * CBT;
  const int nact = min(CBT, p.batch - b0);
  const int K = p.k_steps;

  extern __shared__ float smem[];
  float* x = smem;                     // [CBT][n_in]
  float* d = x + CBT * p.n_in;         // [CBT][nd]
  float* h1 = d + CBT * p.nd;          // [CBT][n1]
  float* h1n = h1 + CBT * p.n1;
  float* h2 = h1n + CBT * p.n1;        // [CBT][n2]
  float* h2n = h2 + CBT * p.n2;
  float* out = h2n + CBT * p.n2;       // [CBT][n_out]

  // missing streams of a ragged last block stay zero and write nothing
  for (int i = tid; i < CBT * p.n1; i += CNT) {
    const int s = i / p.n1;
    h1[i] = s < nact ? p.h1_in[(size_t)(b0 + s) * p.n1 + i % p.n1] : 0.f;
  }
  for (int i = tid; i < CBT * p.n2; i += CNT) {
    const int s = i / p.n2;
    h2[i] = s < nact ? p.h2_in[(size_t)(b0 + s) * p.n2 + i % p.n2] : 0.f;
  }

  for (int k = 0; k < K; ++k) {
    for (int i = tid; i < CBT * p.n_in; i += CNT) {
      const int s = i / p.n_in;
      x[i] = s < nact ? p.inputs[((size_t)(b0 + s) * K + k) * p.n_in + i % p.n_in] : 0.f;
    }
    __syncthreads();
    dense<true>(p.d1_w, p.d1_b, p.n_in, p.nd, x, d, tid);
    __syncthreads();
    gru_step(p.g1_in, p.g1_rec, p.g1_b, p.nd, p.n1, d, h1, h1n, tid);
    __syncthreads();
    gru_step(p.g2_in, p.g2_rec, p.g2_b, p.n1, p.n2, h1n, h2, h2n, tid);
    __syncthreads();
    dense<false>(p.out_w, p.out_b, p.n2, p.n_out, h2n, out, tid);
    __syncthreads();

    // masked state update; the states after the step and the raw output go out
    for (int i = tid; i < nact * p.n1; i += CNT) {
      const int s = i / p.n1;
      if (p.masks[(size_t)(b0 + s) * K + k] > 0) h1[i] = h1n[i];
      p.h1_seq[((size_t)(b0 + s) * K + k) * p.n1 + i % p.n1] = h1[i];
    }
    for (int i = tid; i < nact * p.n2; i += CNT) {
      const int s = i / p.n2;
      if (p.masks[(size_t)(b0 + s) * K + k] > 0) h2[i] = h2n[i];
      p.h2_seq[((size_t)(b0 + s) * K + k) * p.n2 + i % p.n2] = h2[i];
    }
    for (int i = tid; i < nact * p.n_out; i += CNT) {
      const int s = i / p.n_out;
      p.outs[((size_t)(b0 + s) * K + k) * p.n_out + i % p.n_out] = out[i];
    }
    __syncthreads();
  }
}

extern "C" int lpcnet_plc_chain(
    int batch, int k_steps, int n_in, int nd, int n1, int n2, int n_out,
    const void* d1_w, const void* d1_b, const void* g1_in, const void* g1_rec, const void* g1_b,
    const void* g2_in, const void* g2_rec, const void* g2_b, const void* out_w, const void* out_b,
    const void* inputs, const void* masks, const void* h1_in, const void* h2_in,
    void* h1_seq, void* h2_seq, void* outs, void* stream) {
  if (batch <= 0 || k_steps <= 0) return (int)cudaErrorInvalidValue;
  ChainArgs a;
  a.batch = batch; a.k_steps = k_steps; a.n_in = n_in; a.nd = nd; a.n1 = n1; a.n2 = n2;
  a.n_out = n_out;
  a.d1_w = (const float*)d1_w; a.d1_b = (const float*)d1_b;
  a.g1_in = (const float*)g1_in; a.g1_rec = (const float*)g1_rec; a.g1_b = (const float*)g1_b;
  a.g2_in = (const float*)g2_in; a.g2_rec = (const float*)g2_rec; a.g2_b = (const float*)g2_b;
  a.out_w = (const float*)out_w; a.out_b = (const float*)out_b;
  a.inputs = (const float*)inputs; a.masks = (const int*)masks;
  a.h1_in = (const float*)h1_in; a.h2_in = (const float*)h2_in;
  a.h1_seq = (float*)h1_seq; a.h2_seq = (float*)h2_seq; a.outs = (float*)outs;
  const size_t smem = sizeof(float) * (size_t)CBT * (n_in + nd + 2 * n1 + 2 * n2 + n_out);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chain_kernel<<<(batch + CBT - 1) / CBT, CNT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
