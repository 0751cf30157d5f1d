// K1 (f32) at large batches: the LPCNet autoregressive sample loop, one
// frame per launch, free-running, in its first design. K1 is the
// free-running form of masked_loop.cu's cluster kernel, f32 on clusters of
// 16 blocks with GRU-A's f32 slice resident (5x faster at 4 streams); but
// 16-block clusters fit the H100 7 at a time, and each wave of them costs
// about a frame of this kernel, which keeps every block of 4 streams
// resident at once: so f32 K1 runs here above two waves of clusters
// (kernels/sample_loop.py::f32_route; on an H100 above 560 streams). K6,
// the merged-product loop, runs K1's kernel on the non-zero blocks of its
// merged matrices (kernels/sample_loop.py::merged_packs) and is routed the
// same way.
//
// Replaces the TPU kernel lpcnet_tpu/kernels/sample_loop.py::_ar_kernel, run
// free (masked=False, sampled=True: K1), with its helpers _gru_ab,
// _draw_bytes / _kiss99, _bit_tree (v1) and _lin2ulaw / _ulaw2lin. Each
// stream runs n_samples dependent steps: LPC prediction, u-law codes, the three-row
// embedding gather plus the reset-after GRU-A, GRU-B, the dual-FC node
// logits, the 8-bit tree descent on KISS99 threshold bytes, de-emphasis,
// clip and round.
//
// What bounds it on an H100: not the arithmetic (~0.94 MFLOP per stream
// sample, 1.5e11 per frame at 1024 streams) nor device memory (the weights,
// 0.5-5 MB, stay in the 50 MB L2), but the chain of 160 dependent steps, each
// of which streams GRU-A's recurrent matrix ([Na, 3Na]) and gathers three
// embedding rows per stream before the next step can start. The step is
// latency- and L2-bandwidth-bound.
//
// What the design does about it:
// * Streams are independent, so each block owns BT streams and runs all the
//   steps itself: no grid-wide sync, one launch per frame. BT = 4 gives 256
//   blocks at 1024 streams (enough for the 132 SMs); the ragged last block
//   masks the missing streams.
// * Each block reads every weight once per step and applies it to its BT
//   streams (GRU-A: thread u owns unit u and all three of its gate columns,
//   so it forms the new h_a[u] itself with no exchange). Warps read
//   consecutive columns, so the weight loads coalesce.
// * h_a, h_b, the signal history, the node logits and the RNG words stay in
//   shared memory for the whole frame; only the PCM goes out per step.
// * The TPU kernel's one-hot [BT, 768] x [768, 3Na] contraction is a gather
//   here: three rows per stream (q8: their int8 values summed in int32, then
//   scaled per column).
// * KISS99 runs in uint32 registers, bit-exact with the C decoder; bit
//   decisions are `logit - thr > 0`. The scalar helpers live in
//   sample_common.cuh, shared with K2.
// Tensor cores, weights in shared memory across a cluster (as K2 now has
// them) and TMA are later work here.

#include "sample_common.cuh"

#define BT 4            // streams per block
#define NTHREADS 384

struct Args {
  int batch, na, nb, n_samples;
  const void* emb;          // [768, 3Na] f32 / bf16 / int8
  const float* emb_scale;   // [3Na] (q8)
  const void* a_rec;        // [Na, 3Na] (q8: off-diagonal int8)
  const float* a_diag;      // [3Na] (q8)
  const float* a_bias1;     // [3Na]
  const void* b_in;         // [Na, 3Nb]
  const void* b_rec;        // [Nb, 3Nb]
  const float* b_bias1;     // [3Nb]
  const float* dual_w;      // [Nb, 512]
  const float* dual_bias;   // [512]
  const float* dual_factor; // [512]
  const float* logit_table; // [256]
  const float* cond_a;      // [B, 3Na]
  const float* cond_b;      // [B, 3Nb]
  const float* lpc;         // [B, 16]
  const float* ha_in; const float* hb_in; const float* sig_in;
  const int* exc_in; const float* de_in; const long long* rng_in;
  float* ha_out; float* hb_out; float* sig_out;
  int* exc_out; float* de_out; long long* rng_out;
  float* pcm;               // [B, n_samples]
};

// what the two GRU steps read besides the per-stream conditioning
struct GruWeights {
  const void* emb; const float* emb_scale;
  const void* a_rec; const float* a_diag; const float* a_bias1;
  const void* b_in; const void* b_rec; const float* b_bias1;
};

// GRU-A for the block's BT streams: thread u owns unit u (gate columns u,
// Na+u, 2Na+u). hop holds the operand copies of ha; ha is updated in place
// for the streams whose bit is set in `live`. Stream s reads its gate
// conditioning at ca0 + s * ca_stride and its three embedding rows from code.
template <int FORM>
__device__ __forceinline__ void gru_a_phase(const GruWeights& w, int na, const float* ca0,
                                            size_t ca_stride, const float* hop, float* ha,
                                            const int* code, unsigned live, int tid) {
  typedef typename FormT<FORM>::W W;
  typedef typename FormT<FORM>::Acc Acc;
  const W* emb = (const W*)w.emb;
  const W* a_rec = (const W*)w.a_rec;
  const int na3 = 3 * na;
  for (int u = tid; u < na; u += NTHREADS) {
    Acc acc[BT][3];
#pragma unroll
    for (int s = 0; s < BT; ++s) acc[s][0] = acc[s][1] = acc[s][2] = 0;
    for (int k = 0; k < na; ++k) {
      const size_t row = (size_t)k * na3;
      Acc w0 = wload(a_rec, row + u);
      Acc w1 = wload(a_rec, row + na + u);
      Acc w2 = wload(a_rec, row + 2 * na + u);
#pragma unroll
      for (int s = 0; s < BT; ++s) {
        Acc x = (Acc)hop[s * na + k];
        acc[s][0] += x * w0;
        acc[s][1] += x * w1;
        acc[s][2] += x * w2;
      }
    }
#pragma unroll
    for (int s = 0; s < BT; ++s) {
      if (!((live >> s) & 1u)) continue;           // absent or frozen: h_a stays
      const float* ca = ca0 + (size_t)s * ca_stride;
      const int r0 = code[3 * s], r1 = 256 + code[3 * s + 1], r2 = 512 + code[3 * s + 2];
      const float h0 = ha[s * na + u];
      float g[3], zr[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int col = q * na + u;
        if (FORM == FORM_Q8) {
          int e = wload(emb, (size_t)r0 * na3 + col) + wload(emb, (size_t)r1 * na3 + col)
                + wload(emb, (size_t)r2 * na3 + col);
          g[q] = __fadd_rn(ca[col], __fmul_rn((float)e, w.emb_scale[col]));
          zr[q] = __fadd_rn(__fadd_rn(__fmul_rn((float)acc[s][q], Q8_SCALE),
                                      __fmul_rn(w.a_diag[col], h0)),
                            w.a_bias1[col]);
        } else {
          float e = __fadd_rn(__fadd_rn((float)wload(emb, (size_t)r0 * na3 + col),
                                        (float)wload(emb, (size_t)r1 * na3 + col)),
                              (float)wload(emb, (size_t)r2 * na3 + col));
          g[q] = __fadd_rn(ca[col], e);
          zr[q] = __fadd_rn((float)acc[s][q], w.a_bias1[col]);
        }
      }
      ha[s * na + u] = gru_out(g[0], zr[0], g[1], zr[1], g[2], zr[2], h0);
    }
  }
}

// GRU-B: the gate parts, one thread per (stream, gate column) of the nact
// present streams, then the update of hb for the `live` ones. hop and hbop
// hold the operand copies of the new h_a and of h_b; gin and grec are
// [BT][3nb] scratch. Every thread of the block calls it; it ends on a barrier.
template <int FORM>
__device__ __forceinline__ void gru_b_phase(const GruWeights& w, int na, int nb, const float* cb0,
                                            size_t cb_stride, const float* hop,
                                            const float* hbop, float* hb, float* gin,
                                            float* grec, int nact, unsigned live, int tid) {
  typedef typename FormT<FORM>::W W;
  typedef typename FormT<FORM>::Acc Acc;
  const W* b_in = (const W*)w.b_in;
  const W* b_rec = (const W*)w.b_rec;
  const int nb3 = 3 * nb;
  for (int o = tid; o < BT * nb3; o += NTHREADS) {
    const int s = o / nb3, c = o % nb3;
    if (s >= nact) continue;
    Acc ai = 0, ar = 0;
    for (int k = 0; k < na; ++k) ai += (Acc)hop[s * na + k] * (Acc)wload(b_in, (size_t)k * nb3 + c);
    for (int k = 0; k < nb; ++k) ar += (Acc)hbop[s * nb + k] * (Acc)wload(b_rec, (size_t)k * nb3 + c);
    const float cb = cb0[(size_t)s * cb_stride + c];
    if (FORM == FORM_Q8) {
      gin[o] = __fadd_rn(cb, __fmul_rn((float)ai, Q8_SCALE));
      grec[o] = __fadd_rn(__fmul_rn((float)ar, Q8_SCALE), w.b_bias1[c]);
    } else {
      gin[o] = __fadd_rn(cb, (float)ai);
      grec[o] = __fadd_rn((float)ar, w.b_bias1[c]);
    }
  }
  __syncthreads();
  for (int o = tid; o < BT * nb; o += NTHREADS) {
    const int s = o / nb, u = o % nb;
    if (!((live >> s) & 1u)) continue;             // absent or frozen: h_b stays
    const float* gi = gin + s * nb3;
    const float* gr = grec + s * nb3;
    hb[o] = gru_out(gi[u], gr[u], gi[nb + u], gr[nb + u], gi[2 * nb + u], gr[2 * nb + u], hb[o]);
  }
  __syncthreads();
}

template <int FORM>
__global__ void __launch_bounds__(NTHREADS) ar_kernel(Args p) {
  const GruWeights w = {p.emb, p.emb_scale, p.a_rec, p.a_diag, p.a_bias1,
                        p.b_in, p.b_rec, p.b_bias1};
  const int na = p.na, nb = p.nb, na3 = 3 * na, nb3 = 3 * nb;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BT;
  const int nact = min(BT, p.batch - b0);

  extern __shared__ float smem[];
  float* ha = smem;                    // [BT][na] state
  float* hop = ha + BT * na;           // [BT][na] GRU operand copy
  float* hb = hop + BT * na;           // [BT][nb]
  float* hbop = hb + BT * nb;          // [BT][nb]
  float* gin = hbop + BT * nb;         // [BT][3nb] GRU-B input part
  float* grec = gin + BT * nb3;        // [BT][3nb] GRU-B recurrent part
  float* logits = grec + BT * nb3;     // [BT][256]
  float* sig = logits + BT * 256;      // [BT][16]
  float* lpc = sig + BT * LPC_ORDER;   // [BT][16]
  float* de = lpc + BT * LPC_ORDER;    // [BT]
  float* pred = de + BT;               // [BT]
  int* code = (int*)(pred + BT);       // [BT][3] sig_u, pred_u, exc
  unsigned* rng = (unsigned*)(code + 3 * BT);  // [BT][4]

  // load the carried state; missing streams of the last block stay zero
  for (int i = tid; i < BT * na; i += NTHREADS) {
    int s = i / na;
    ha[i] = s < nact ? p.ha_in[(size_t)(b0 + s) * na + i % na] : 0.f;
  }
  for (int i = tid; i < BT * nb; i += NTHREADS) {
    int s = i / nb;
    hb[i] = s < nact ? p.hb_in[(size_t)(b0 + s) * nb + i % nb] : 0.f;
  }
  for (int i = tid; i < BT * LPC_ORDER; i += NTHREADS) {
    int s = i / LPC_ORDER;
    size_t g = (size_t)(b0 + s) * LPC_ORDER + i % LPC_ORDER;
    sig[i] = s < nact ? p.sig_in[g] : 0.f;
    lpc[i] = s < nact ? p.lpc[g] : 0.f;
  }
  if (tid < BT) {
    int s = tid;
    bool on = s < nact;
    de[s] = on ? p.de_in[b0 + s] : 0.f;
    code[3 * s + 2] = on ? p.exc_in[b0 + s] : 0;
    for (int k = 0; k < 4; ++k)
      rng[4 * s + k] = on ? (unsigned)p.rng_in[(size_t)(b0 + s) * 4 + k] : 1u;
  }
  __syncthreads();

  for (int t = 0; t < p.n_samples; ++t) {
    // (a) prediction and u-law codes; operand copies of the GRU states
    if (tid < BT) {
      int s = tid;
      float acc = 0.f;
      for (int j = 0; j < LPC_ORDER; ++j)
        acc = __fadd_rn(acc, __fmul_rn(sig[s * LPC_ORDER + j], lpc[s * LPC_ORDER + j]));
      pred[s] = -acc;
      code[3 * s] = lin2ulaw(sig[s * LPC_ORDER]);
      code[3 * s + 1] = lin2ulaw(-acc);
    }
    for (int i = tid; i < BT * na; i += NTHREADS) hop[i] = operand<FORM>(ha[i]);
    for (int i = tid; i < BT * nb; i += NTHREADS) hbop[i] = operand<FORM>(hb[i]);
    __syncthreads();

    // the streams that move this step: the present ones
    const unsigned live = (1u << nact) - 1u;

    // (b) GRU-A, (c) GRU-B
    gru_a_phase<FORM>(w, na, p.cond_a + (size_t)b0 * na3, (size_t)na3, hop, ha, code, live, tid);
    __syncthreads();
    for (int i = tid; i < BT * na; i += NTHREADS) hop[i] = operand<FORM>(ha[i]);
    __syncthreads();
    gru_b_phase<FORM>(w, na, nb, p.cond_b + (size_t)b0 * nb3, (size_t)nb3, hop, hbop, hb, gin,
                      grec, nact, live, tid);

    // (d) dual-FC node logits: both channels of node n from columns n, 256+n
    for (int o = tid; o < BT * 256; o += NTHREADS) {
      const int s = o >> 8, n = o & 255;
      if (s >= nact) continue;
      float p0 = 0.f, p1 = 0.f;
      for (int k = 0; k < nb; ++k) {
        const float h = hb[s * nb + k];
        p0 += h * p.dual_w[k * 512 + n];
        p1 += h * p.dual_w[k * 512 + 256 + n];
      }
      const float t0 = __fmul_rn(p.dual_factor[n], tanhf(__fadd_rn(p0, p.dual_bias[n])));
      const float t1 = __fmul_rn(p.dual_factor[256 + n], tanhf(__fadd_rn(p1, p.dual_bias[256 + n])));
      logits[o] = __fadd_rn(t0, t1);
    }
    __syncthreads();

    // (e) tree descent, excitation -> PCM, state update: one thread per stream
    if (tid < nact) {
      const int s = tid;
      unsigned* st = rng + 4 * s;
      const unsigned r1 = kiss99(st);
      const unsigned r2 = kiss99(st);
      int val = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const unsigned byte = ((b < 4 ? r1 : r2) >> (8 * (b & 3))) & 0xFFu;
        const float diff = __fsub_rn(logits[s * 256 + ((1 << b) | val)], p.logit_table[byte]);
        val = (val << 1) | (diff > 0.f ? 1 : 0);
      }
      const float pcm = __fadd_rn(pred[s], ulaw2lin(val));
      float* hist = sig + s * LPC_ORDER;
      for (int j = LPC_ORDER - 1; j > 0; --j) hist[j] = hist[j - 1];
      hist[0] = pcm;
      code[3 * s + 2] = val;
      const float out = __fadd_rn(pcm, __fmul_rn(PREEMPH, de[s]));
      de[s] = out;
      p.pcm[(size_t)(b0 + s) * p.n_samples + t] =
          floorf(__fadd_rn(0.5f, fminf(fmaxf(out, -32767.f), 32767.f)));
    }
    __syncthreads();
  }

  // write the carried state back
  for (int i = tid; i < nact * na; i += NTHREADS)
    p.ha_out[(size_t)(b0 + i / na) * na + i % na] = ha[i];
  for (int i = tid; i < nact * nb; i += NTHREADS)
    p.hb_out[(size_t)(b0 + i / nb) * nb + i % nb] = hb[i];
  for (int i = tid; i < nact * LPC_ORDER; i += NTHREADS)
    p.sig_out[(size_t)(b0 + i / LPC_ORDER) * LPC_ORDER + i % LPC_ORDER] = sig[i];
  if (tid < nact) {
    const int s = tid;
    p.de_out[b0 + s] = de[s];
    p.exc_out[b0 + s] = code[3 * s + 2];
    for (int k = 0; k < 4; ++k) p.rng_out[(size_t)(b0 + s) * 4 + k] = (long long)rng[4 * s + k];
  }
}

static size_t smem_bytes(int na, int nb) {
  return sizeof(float) * ((size_t)BT * (2 * na + 2 * nb + 6 * nb + 256 + 2 * LPC_ORDER + 2))
       + sizeof(int) * 3 * BT + sizeof(unsigned) * 4 * BT;
}

template <int FORM>
static cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.na, a.nb);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ar_kernel<FORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = (a.batch + BT - 1) / BT;
  ar_kernel<FORM><<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}


#define SAMPLE_LOOP_PARAMS \
    int form, int batch, int na, int nb, int n_samples, \
    const void* emb, const void* emb_scale, const void* a_rec, const void* a_diag, \
    const void* a_bias1, const void* b_in, const void* b_rec, const void* b_bias1, \
    const void* dual_w, const void* dual_bias, const void* dual_factor, \
    const void* logit_table, const void* cond_a, const void* cond_b, const void* lpc, \
    const void* ha_in, const void* hb_in, const void* sig_in, const void* exc_in, \
    const void* de_in, const void* rng_in, \
    void* ha_out, void* hb_out, void* sig_out, void* exc_out, void* de_out, \
    void* rng_out, void* pcm

#define SAMPLE_LOOP_ARGS \
    form, batch, na, nb, n_samples, emb, emb_scale, a_rec, a_diag, a_bias1, b_in, b_rec, \
    b_bias1, dual_w, dual_bias, dual_factor, logit_table, cond_a, cond_b, lpc, ha_in, hb_in, \
    sig_in, exc_in, de_in, rng_in, ha_out, hb_out, sig_out, exc_out, de_out, rng_out, pcm

static Args make_args(SAMPLE_LOOP_PARAMS) {
  (void)form;
  Args a;
  a.batch = batch; a.na = na; a.nb = nb; a.n_samples = n_samples;
  a.emb = emb; a.emb_scale = (const float*)emb_scale;
  a.a_rec = a_rec; a.a_diag = (const float*)a_diag; a.a_bias1 = (const float*)a_bias1;
  a.b_in = b_in; a.b_rec = b_rec; a.b_bias1 = (const float*)b_bias1;
  a.dual_w = (const float*)dual_w; a.dual_bias = (const float*)dual_bias;
  a.dual_factor = (const float*)dual_factor; a.logit_table = (const float*)logit_table;
  a.cond_a = (const float*)cond_a; a.cond_b = (const float*)cond_b; a.lpc = (const float*)lpc;
  a.ha_in = (const float*)ha_in; a.hb_in = (const float*)hb_in; a.sig_in = (const float*)sig_in;
  a.exc_in = (const int*)exc_in; a.de_in = (const float*)de_in;
  a.rng_in = (const long long*)rng_in;
  a.ha_out = (float*)ha_out; a.hb_out = (float*)hb_out; a.sig_out = (float*)sig_out;
  a.exc_out = (int*)exc_out; a.de_out = (float*)de_out; a.rng_out = (long long*)rng_out;
  a.pcm = (float*)pcm;
  return a;
}

// K1 in the f32 form: free-running. The bf16 and q8 forms run the
// free-running form of masked_loop.cu's cluster kernel.
extern "C" int lpcnet_sample_loop(SAMPLE_LOOP_PARAMS, void* stream) {
  if (batch <= 0 || n_samples <= 0 || form != FORM_F32) return (int)cudaErrorInvalidValue;
  const Args a = make_args(SAMPLE_LOOP_ARGS);
  return (int)launch<FORM_F32>(a, (cudaStream_t)stream);
}
