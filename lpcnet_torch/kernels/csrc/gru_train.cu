// K5: the training recurrence of the reset-after GRU over precomputed gate
// inputs, forward and backward.
//
// Replaces the TPU kernels lpcnet_tpu/kernels/gru_train.py::_fwd_kernel and
// ::_bwd_kernel (the custom VJP gru_recurrence). Per step
//   zrec = bf16(h) . bf16(Wr) + br          (f32 sums)
//   z = sigmoid(g_z + zrec_z), r = sigmoid(g_r + zrec_r)
//   hcand = tanh(g_h + r * zrec_h),  h' = z*h + (1-z)*hcand
// with g = gate_in[:, t] = x.kernel + bias[0], computed outside as in the JAX
// package. The backward runs in reverse time, recomputes the gates from
// hprev = [h0, hs[:-1]], emits dgate_in and dh0, carries
// dh = d*z + bf16(dzrec) . bf16(Wr^T), and accumulates
// dWr = sum bf16(hprev)^T . bf16(dzrec) and dbr = sum dzrec.
//
// What bounds it on an H100: the chain of T dependent steps. The bytes
// (gate_in read, hs written: 1.9 GB at B=128, T=2400, N=384) and the bf16
// operations are each under a millisecond of the card; a step, though, is a
// full sweep of Wr (0.88 MB in bf16 at N=384, twice in the backward with
// Wr^T) from L2 for every group of streams, plus barriers.
//
// What the design does about it:
// * Streams are independent: a cluster of thread blocks owns 4 streams for
//   all T steps, with no grid sync. The TPU kernel's time blocks, its batch
//   tiles and the padding of small GRUs to 128 lanes are gone: any B, any T,
//   any N that is a multiple of 16 (up to 1024).
// * At N >= 256 the cluster has 4 blocks (4 SMs), each owning a quarter of
//   the units: it sweeps only its quarter of Wr's columns a step, so four
//   SMs' L2 bandwidth serve one group of streams. The new h (rounded to
//   bf16, the operand of the next step) goes to all four blocks through
//   distributed shared memory, double-buffered, behind one cluster barrier
//   a step. A small GRU runs as a cluster of one block.
// * Inside a block the k range of a product is split over 4 thread groups
//   (more loads in flight); the partial sums meet in shared memory, and
//   thread (stream s, unit u) then does the gate arithmetic of its one
//   stream and unit. That thread keeps h (forward) or dh and its dbr sums
//   (backward) in registers for the whole sequence, and loads next step's
//   gate inputs a step ahead.
// * Wr is repacked by the wrapper to [N/4][3][N][4] bf16 (and Wr^T to
//   [3N/4][N][4]): one 8-byte load brings four k of one gate column, and a
//   warp's loads are contiguous. The weights stay in L2.
// * dWr is not accumulated inside the time loop (a cluster has 4 streams,
//   and a [N, 3N] f32 accumulator does not fit on chip). The recurrence
//   writes dzrec's candidate part (dg holds the rest), and a second kernel
//   here forms hprev^T . dzrec on the tensor cores (WMMA, bf16 operands
//   rounded on load, f32 sums), split over rows into partial results. A
//   third kernel adds the partials, and the streams' dbr partials, in a
//   fixed order: no float atomics, so two runs give the same bits.
// * At N <= 32 the forward is a warp-synchronous kernel of its own (below
//   gru_fwd_kernel): no shared memory and no barrier a step.
// Wr resident in shared memory across a larger cluster, and tensor cores in
// the recurrence, are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

#define BT 4   // streams per cluster
#define KG 4   // thread groups a product's k range is split over (== BT)

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// four consecutive bf16 values (8-byte aligned) as floats
__device__ __forceinline__ void load4(const bf16* p, float (&w)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}

// acc[s][g] = sum over k in [4 kq0, 4 kq1) of hop[s][k] * Wr[k][g*n + u];
// wp is [n/4][3][n][4], hop is [BT][n]
__device__ __forceinline__ void rec_partial(const bf16* __restrict__ wp, const float* hop,
                                            int n, int u, int kq0, int kq1,
                                            float (&acc)[BT][3]) {
#pragma unroll
  for (int s = 0; s < BT; ++s) acc[s][0] = acc[s][1] = acc[s][2] = 0.f;
#pragma unroll 8
  for (int kq = kq0; kq < kq1; ++kq) {
    float w[3][4];
#pragma unroll
    for (int g = 0; g < 3; ++g) load4(wp + ((size_t)(kq * 3 + g) * n + u) * 4, w[g]);
#pragma unroll
    for (int s = 0; s < BT; ++s) {
      const float4 h = *reinterpret_cast<const float4*>(hop + s * n + 4 * kq);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        acc[s][g] = fmaf(h.x, w[g][0], acc[s][g]);
        acc[s][g] = fmaf(h.y, w[g][1], acc[s][g]);
        acc[s][g] = fmaf(h.z, w[g][2], acc[s][g]);
        acc[s][g] = fmaf(h.w, w[g][3], acc[s][g]);
      }
    }
  }
}

// the barrier of a step: across the cluster, or the cheaper block barrier
// where the cluster is one block
__device__ __forceinline__ void step_barrier(cg::cluster_group& cluster, int csize) {
  if (csize == 1) __syncthreads(); else cluster.sync();
}

// Thread roles in a block of KG * nu threads that owns units
// [rank * nu, (rank + 1) * nu) of its cluster's BT streams:
//   product role  (kg = tid / nu, ul = tid % nu): the kg-th part of the k
//                  range for unit ul, all BT streams;
//   finalize role (fs = tid / nu, ul): stream fs, unit ul (KG == BT).

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void gru_fwd_kernel(int batch, int T, int n, int nu,
                               const bf16* __restrict__ wp, const float* __restrict__ br,
                               const float* __restrict__ gate_in,
                               const float* __restrict__ h0,
                               float* __restrict__ hs, float* __restrict__ hT) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) float smem[];
  float* hop = smem;                    // [2][BT][n] operand copy of h
  float* part = smem + 2 * BT * n;      // [KG][BT][3][nu] partial products
  const int tid = threadIdx.x;
  const int n3 = 3 * n;
  const int kg = tid / nu, ul = tid % nu;
  const int fs = kg;
  const int u = rank * nu + ul;
  const int b0 = (blockIdx.x / csize) * BT;
  const int b = b0 + fs;
  const bool on = b < batch;
  const int nq = n >> 2;
  const int kq0 = kg * nq / KG, kq1 = (kg + 1) * nq / KG;

  float h = on ? h0[(size_t)b * n + u] : 0.f;
  float brv[3], g[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    brv[q] = br[q * n + u];
    g[q] = on ? gate_in[((size_t)b * T) * n3 + q * n + u] : 0.f;
  }
  for (int i = tid; i < BT * n; i += blockDim.x) {
    const int s = i / n;
    hop[i] = b0 + s < batch ? bf16r(h0[(size_t)(b0 + s) * n + i % n]) : 0.f;
  }
  cluster.sync();   // every block of the cluster runs before remote stores

  for (int t = 0; t < T; ++t) {
    const float* cur = hop + (t & 1) * BT * n;
    float* nxt = hop + ((t & 1) ^ 1) * BT * n;
    // next step's gate inputs, a step ahead of their use
    float gn[3] = {0.f, 0.f, 0.f};
    if (on && t + 1 < T) {
#pragma unroll
      for (int q = 0; q < 3; ++q) gn[q] = gate_in[((size_t)b * T + t + 1) * n3 + q * n + u];
    }
    float acc[BT][3];
    rec_partial(wp, cur, n, u, kq0, kq1, acc);
#pragma unroll
    for (int s = 0; s < BT; ++s)
#pragma unroll
      for (int q = 0; q < 3; ++q) part[((kg * BT + s) * 3 + q) * nu + ul] = acc[s][q];
    __syncthreads();
    float zr[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float a = 0.f;
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) a += part[((kk * BT + fs) * 3 + q) * nu + ul];
      zr[q] = a + brv[q];
    }
    const float z = sigmoidf_(g[0] + zr[0]);
    const float r = sigmoidf_(g[1] + zr[1]);
    const float hc = tanhf(g[2] + r * zr[2]);
    h = z * h + (1.f - z) * hc;
    const float hb = bf16r(h);
    for (int c = 0; c < csize; ++c) cluster.map_shared_rank(nxt, c)[fs * n + u] = hb;
    if (on) hs[((size_t)b * T + t) * n + u] = h;
#pragma unroll
    for (int q = 0; q < 3; ++q) g[q] = gn[q];
    // the new operand copy is complete in every block; nobody still reads
    // the buffer the step after next overwrites
    step_barrier(cluster, csize);
  }
  if (on) hT[(size_t)b * n + u] = h;
}

// ---------------------------------------------------------------------------
// forward at N <= 32 units: warp-synchronous
// ---------------------------------------------------------------------------
//
// At 16 units the cluster design above spends a step on a 16-deep product
// split over 4 thread groups, partial sums met in shared memory behind a
// block barrier, the operand copy written back and a second barrier: 48
// multiply-adds a thread for ~0.59 us on an H100. Here a stream is N lanes
// of one warp (two streams a warp at N = 16, one at N = 32) and lane u owns
// unit u for the whole sequence: its 3N columns of Wr (bf16, widened) sit in
// registers and the bf16 operand of h_{t} reaches the other lanes by
// __shfl_sync. No barrier a step. The gate inputs stream through a ring of
// two CH-step chunks in shared memory filled by cp.async, a chunk ahead: a
// register ring loaded a few steps ahead left every step waiting on the
// load (1.20 ms against 0.66 at B=128, T=2400 on an H100). The arithmetic
// is the cluster kernel's: bf16 operands, f32 sums, reset-after gates, hs in
// f32. The cut at 32: above it a stream's units no longer fit in one warp,
// and the lane's 3N weights would crowd out the registers (96 at N = 32).

#define CH 32   // steps a chunk of the gate-input ring

// sigmoidf_ with the reciprocal's rounding instruction in place of a
// division: 1/x rounded to nearest is the same float either way, and the
// reciprocal is the shorter dependent chain
__device__ __forceinline__ float sigmoid_rcp(float x) { return __frcp_rn(1.f + expf(-x)); }

// 16 bytes global -> shared, asynchronously; `bytes` 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

template <int N>
__global__ void __launch_bounds__(32) gru_fwd_warp_kernel(
    int batch, int T, const bf16* __restrict__ wp, const float* __restrict__ br,
    const float* __restrict__ gate_in, const float* __restrict__ h0,
    float* __restrict__ hs, float* __restrict__ hT) {
  constexpr int N3 = 3 * N, SPW = 32 / N, WPS = N3 / 4;   // streams a warp, words a row
  __shared__ __align__(16) float ring[2][CH][SPW * N3];
  const int lane = threadIdx.x;
  const int u = lane % N, sub = lane / N;
  const int b0 = blockIdx.x * SPW, b = b0 + sub;
  const bool on = b < batch;

  // w[q][k] = Wr[k][q N + u]; wp is [N/4][3][N][4]
  float w[3][N];
#pragma unroll
  for (int kq = 0; kq < N / 4; ++kq)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float v[4];
      load4(wp + ((size_t)(kq * 3 + q) * N + u) * 4, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) w[q][4 * kq + j] = v[j];
    }
  float brv[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) brv[q] = br[q * N + u];
  float h = on ? h0[(size_t)b * N + u] : 0.f;
  float hop = bf16r(h);

  // chunk c: the gate-input rows of steps [c CH, c CH + CH) of the warp's
  // streams, zeros past the batch or the sequence; one commit group each
  const int nch = (T + CH - 1) / CH;
  auto fetch = [&](int c) {
    for (int i = lane; i < CH * SPW * WPS; i += 32) {
      const int d = i / (SPW * WPS), ss = (i / WPS) % SPW, wd = i % WPS, t = c * CH + d;
      const bool ok = b0 + ss < batch && t < T;
      const float* src = ok ? gate_in + ((size_t)(b0 + ss) * T + t) * N3 + wd * 4 : gate_in;
      cp_async16(&ring[c & 1][d][ss * N3 + wd * 4], src, ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  fetch(0);
  if (nch > 1) fetch(1); else asm volatile("cp.async.commit_group;\n" ::);

  for (int c = 0; c < nch; ++c) {
    asm volatile("cp.async.wait_group 1;\n" ::);       // chunk c has landed
    __syncwarp();
    const float* gr = &ring[c & 1][0][sub * N3 + u];
    const int steps = min(CH, T - c * CH);
#pragma unroll 4
    for (int d = 0; d < steps; ++d) {
      const int t = c * CH + d;
      const float gz = gr[d * SPW * N3], gg = gr[d * SPW * N3 + N], gh = gr[d * SPW * N3 + 2 * N];
      float a[3][2];
#pragma unroll
      for (int q = 0; q < 3; ++q) a[q][0] = a[q][1] = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float x = __shfl_sync(0xffffffffu, hop, k, N);
#pragma unroll
        for (int q = 0; q < 3; ++q) a[q][k & 1] = fmaf(x, w[q][k], a[q][k & 1]);
      }
      const float zr0 = (a[0][0] + a[0][1]) + brv[0];
      const float zr1 = (a[1][0] + a[1][1]) + brv[1];
      const float zr2 = (a[2][0] + a[2][1]) + brv[2];
      const float z = sigmoid_rcp(gz + zr0);
      const float r = sigmoid_rcp(gg + zr1);
      const float hc = tanhf(gh + r * zr2);
      h = z * h + (1.f - z) * hc;
      hop = bf16r(h);
      if (on) hs[((size_t)b * T + t) * N + u] = h;
    }
    __syncwarp();                                       // the buffer is free again
    if (c + 2 < nch) fetch(c + 2); else asm volatile("cp.async.commit_group;\n" ::);
  }
  if (on) hT[(size_t)b * N + u] = h;
}

// ---------------------------------------------------------------------------
// backward: the reverse-time recurrence
// ---------------------------------------------------------------------------

__global__ void gru_bwd_kernel(int batch, int T, int n, int nu,
                               const bf16* __restrict__ wp, const bf16* __restrict__ wtp,
                               const float* __restrict__ br,
                               const float* __restrict__ gate_in,
                               const float* __restrict__ h0, const float* __restrict__ hs,
                               const float* __restrict__ dhs, const float* __restrict__ dhT,
                               float* __restrict__ dg, float* __restrict__ dzh,
                               float* __restrict__ dh0, float* __restrict__ dbr_part) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) float smem[];
  const int n3 = 3 * n;
  float* hpop = smem;                       // [BT][n]     bf16(hprev)
  float* dzr = hpop + BT * n;               // [2][BT][3n] bf16(dzrec)
  float* part = dzr + 2 * BT * n3;          // [KG][BT][3][nu]
  const int tid = threadIdx.x;
  const int kg = tid / nu, ul = tid % nu;
  const int fs = kg;
  const int u = rank * nu + ul;
  const int b0 = (blockIdx.x / csize) * BT;
  const int b = b0 + fs;
  const bool on = b < batch;
  const int nq = n >> 2;
  const int kq0 = kg * nq / KG, kq1 = (kg + 1) * nq / KG;
  const int jq0 = kg * (3 * nq) / KG, jq1 = (kg + 1) * (3 * nq) / KG;

  // hprev of step t: h0 at t == 0, else hs[:, t - 1]
  auto hprev = [&](int bb, int t, int k) -> float {
    return t > 0 ? hs[((size_t)bb * T + t - 1) * n + k] : h0[(size_t)bb * n + k];
  };

  float dh = on ? dhT[(size_t)b * n + u] : 0.f;
  float brv[3], dbr[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 3; ++q) brv[q] = br[q * n + u];
  // this step's loads, made a step ahead: own gate inputs, dhs and hprev
  float g[3] = {0.f, 0.f, 0.f}, dv = 0.f, hp = 0.f;
  if (on) {
    const size_t row = (size_t)b * T + T - 1;
#pragma unroll
    for (int q = 0; q < 3; ++q) g[q] = gate_in[row * n3 + q * n + u];
    dv = dhs[row * n + u];
    hp = hprev(b, T - 1, u);
  }
  cluster.sync();   // every block of the cluster runs before remote stores

  for (int t = T - 1; t >= 0; --t) {
    float* dz = dzr + (t & 1) * BT * n3;
    // the whole hprev of the cluster's streams, as operand, in every block
    for (int i = tid; i < BT * n; i += blockDim.x) {
      const int s = i / n;
      hpop[i] = b0 + s < batch ? bf16r(hprev(b0 + s, t, i % n)) : 0.f;
    }
    float gn[3] = {0.f, 0.f, 0.f}, dvn = 0.f, hpn = 0.f;
    if (on && t > 0) {
      const size_t row = (size_t)b * T + t - 1;
#pragma unroll
      for (int q = 0; q < 3; ++q) gn[q] = gate_in[row * n3 + q * n + u];
      dvn = dhs[row * n + u];
      hpn = hprev(b, t - 1, u);
    }
    __syncthreads();
    float acc[BT][3];
    rec_partial(wp, hpop, n, u, kq0, kq1, acc);
#pragma unroll
    for (int s = 0; s < BT; ++s)
#pragma unroll
      for (int q = 0; q < 3; ++q) part[((kg * BT + s) * 3 + q) * nu + ul] = acc[s][q];
    __syncthreads();
    float zr[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float a = 0.f;
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) a += part[((kk * BT + fs) * 3 + q) * nu + ul];
      zr[q] = a + brv[q];
    }
    const float z = sigmoidf_(g[0] + zr[0]);
    const float r = sigmoidf_(g[1] + zr[1]);
    const float hc = tanhf(g[2] + r * zr[2]);
    const float d = dh + dv;
    const float dzv = d * (hp - hc);
    const float dph = d * (1.f - z) * (1.f - hc * hc);
    const float dr = dph * zr[2];
    const float dpz = dzv * z * (1.f - z);
    const float dpr = dr * r * (1.f - r);
    const float dzh_v = dph * r;
    if (on) {
      const size_t row = (size_t)b * T + t;
      dg[row * n3 + u] = dpz;
      dg[row * n3 + n + u] = dpr;
      dg[row * n3 + 2 * n + u] = dph;
      dzh[row * n + u] = dzh_v;
    }
    const float o0 = bf16r(dpz), o1 = bf16r(dpr), o2 = bf16r(dzh_v);
    for (int c = 0; c < csize; ++c) {
      float* zrow = cluster.map_shared_rank(dz, c) + fs * n3;
      zrow[u] = o0;
      zrow[n + u] = o1;
      zrow[2 * n + u] = o2;
    }
    dbr[0] += dpz; dbr[1] += dpr; dbr[2] += dzh_v;
    const float dkeep = d * z;
    // dzrec is complete in every block (the buffer alternates with t, so a
    // block a step ahead cannot overwrite what another still reads)
    step_barrier(cluster, csize);

    // dh = d*z + bf16(dzrec) . bf16(Wr^T); wtp is [3n/4][n][4]
    float a[BT];
#pragma unroll
    for (int s = 0; s < BT; ++s) a[s] = 0.f;
#pragma unroll 8
    for (int jq = jq0; jq < jq1; ++jq) {
      float w[4];
      load4(wtp + ((size_t)jq * n + u) * 4, w);
#pragma unroll
      for (int s = 0; s < BT; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(dz + s * n3 + 4 * jq);
        a[s] = fmaf(v.x, w[0], a[s]);
        a[s] = fmaf(v.y, w[1], a[s]);
        a[s] = fmaf(v.z, w[2], a[s]);
        a[s] = fmaf(v.w, w[3], a[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < BT; ++s) part[(kg * BT + s) * nu + ul] = a[s];
    __syncthreads();
    float sum = 0.f;
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) sum += part[(kk * BT + fs) * nu + ul];
    dh = dkeep + sum;
#pragma unroll
    for (int q = 0; q < 3; ++q) g[q] = gn[q];
    dv = dvn;
    hp = hpn;
    // the next step's first barrier comes before `part` and `hpop` change
  }
  if (on) dh0[(size_t)b * n + u] = dh;
  // one dbr partial per stream slot (streams beyond the batch add zeros)
  float* out = dbr_part + (size_t)b * n3;
#pragma unroll
  for (int q = 0; q < 3; ++q) out[q * n + u] = dbr[q];
}

// ---------------------------------------------------------------------------
// backward: dWr partials, part p = sum over its rows (b, t) of
// bf16(hprev[row])^T . bf16(dzrec[row]) on the tensor cores
// ---------------------------------------------------------------------------

#define GT_M 128     // tile over hprev units (rows of dWr)
#define GT_N 128     // tile over gate columns
#define GT_K 32      // (b, t) rows per stage
#define GT_LD 136    // padded leading dimension in shared memory

__device__ __forceinline__ void store4_bf16(bf16* dst, float4 v) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(v.z, v.w);
}

__global__ void __launch_bounds__(256) dwr_kernel(
    int batch, int T, int n, long long rows_per_part,
    const float* __restrict__ h0, const float* __restrict__ hs,
    const float* __restrict__ dg, const float* __restrict__ dzh,
    float* __restrict__ part) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[GT_K * GT_LD];   // [row][unit]
  __shared__ __align__(32) bf16 Bs[GT_K * GT_LD];   // [row][gate column]
  __shared__ __align__(32) float stage[8][256];
  const int n3 = 3 * n;
  const int i0 = blockIdx.x * GT_M, j0 = blockIdx.y * GT_N;
  const long long rows = (long long)batch * T;
  const long long r_begin = (long long)blockIdx.z * rows_per_part;
  const long long r_end = min(rows, r_begin + rows_per_part);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;          // 4 x 2 warps, 32 x 64 each

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) wmma::fill_fragment(c[mi][ni], 0.f);

  for (long long r0 = r_begin; r0 < r_end; r0 += GT_K) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + q * 256;
      const int row = idx >> 5, col = (idx & 31) * 4;
      const long long r = r0 + row;
      float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
      if (r < r_end) {
        const long long b = r / T;
        const int t = (int)(r - b * T);
        if (i0 + col < n) {
          const float* src = t > 0 ? hs + (size_t)(r - 1) * n : h0 + (size_t)b * n;
          av = *reinterpret_cast<const float4*>(src + i0 + col);
        }
        const int j = j0 + col;
        if (j < n3) {
          const float* src = j < 2 * n ? dg + (size_t)r * n3 + j
                                       : dzh + (size_t)r * n + (j - 2 * n);
          bv = *reinterpret_cast<const float4*>(src);
        }
      }
      store4_bf16(As + row * GT_LD + col, av);
      store4_bf16(Bs + row * GT_LD + col, bv);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GT_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        wmma::load_matrix_sync(a[mi], As + kk * GT_LD + wm * 32 + mi * 16, GT_LD);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        wmma::load_matrix_sync(b[ni], Bs + kk * GT_LD + wn * 64 + ni * 16, GT_LD);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) wmma::mma_sync(c[mi][ni], a[mi], b[ni], c[mi][ni]);
    }
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.z * n * n3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      wmma::store_matrix_sync(stage[warp], c[mi][ni], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int i = i0 + wm * 32 + mi * 16 + (e >> 4);
        const int j = j0 + wn * 64 + ni * 16 + (e & 15);
        if (i < n && j < n3) out[(size_t)i * n3 + j] = stage[warp][e];
      }
      __syncwarp();
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in that order
__global__ void reduce_parts_kernel(int count, int parts, const float* __restrict__ part,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[(size_t)p * count + i];
  out[i] = s;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_config(int batch, int T, int n, int cluster, int threads) {
  return batch <= 0 || T <= 0 || n <= 0 || n % 16 != 0 || cluster <= 0 || cluster > 8 ||
         n % cluster != 0 || threads != KG * (n / cluster) || threads > 1024;
}

// grid of ceil(batch / BT) clusters of `cluster` blocks each
cudaLaunchConfig_t cluster_launch(int batch, int cluster, int threads, size_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((batch + BT - 1) / BT) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" int lpcnet_gru_train_fwd(int batch, int T, int n, int cluster, int threads,
                                    const void* wp, const void* br, const void* gate_in,
                                    const void* h0, void* hs, void* hT, void* stream) {
  if (bad_config(batch, T, n, cluster, threads)) return (int)cudaErrorInvalidValue;
  const int nu = n / cluster;
  const size_t smem = sizeof(float) * ((size_t)2 * BT * n + (size_t)KG * BT * 3 * nu);
  cudaError_t e;
  if ((e = allow_smem(gru_fwd_kernel, smem)) != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_launch(batch, cluster, threads, smem,
                                          (cudaStream_t)stream, &attr);
  e = cudaLaunchKernelEx(&cfg, gru_fwd_kernel, batch, T, n, nu, (const bf16*)wp,
                         (const float*)br, (const float*)gate_in, (const float*)h0,
                         (float*)hs, (float*)hT);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the warp-synchronous forward, N = 16 or 32; wp as in lpcnet_gru_train_fwd
extern "C" int lpcnet_gru_train_fwd_warp(int batch, int T, int n, const void* wp,
                                         const void* br, const void* gate_in, const void* h0,
                                         void* hs, void* hT, void* stream) {
  if (batch <= 0 || T <= 0 || (n != 16 && n != 32)) return (int)cudaErrorInvalidValue;
  const int grid = (batch + 32 / n - 1) / (32 / n);
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* w = (const bf16*)wp;
  if (n == 16)
    gru_fwd_warp_kernel<16><<<grid, 32, 0, s>>>(batch, T, w, (const float*)br,
                                                (const float*)gate_in, (const float*)h0,
                                                (float*)hs, (float*)hT);
  else
    gru_fwd_warp_kernel<32><<<grid, 32, 0, s>>>(batch, T, w, (const float*)br,
                                                (const float*)gate_in, (const float*)h0,
                                                (float*)hs, (float*)hT);
  return (int)cudaGetLastError();
}

// dbr_part is [ceil(batch / 4) * 4][3n]; dwr_part is [parts][n][3n]. With
// want_w == 0 only dg, dzh and dh0 are produced.
extern "C" int lpcnet_gru_train_bwd(int batch, int T, int n, int cluster, int threads,
                                    const void* wp, const void* wtp, const void* br,
                                    const void* gate_in, const void* h0, const void* hs,
                                    const void* dhs, const void* dhT,
                                    void* dg, void* dzh, void* dh0, void* dbr_part,
                                    int want_w, int parts, void* dwr_part,
                                    void* dwr, void* dbr, void* stream) {
  if (bad_config(batch, T, n, cluster, threads)) return (int)cudaErrorInvalidValue;
  if (want_w && parts <= 0) return (int)cudaErrorInvalidValue;
  const int nu = n / cluster;
  const int n3 = 3 * n;
  const size_t smem = sizeof(float) * ((size_t)BT * n + (size_t)2 * BT * n3 +
                                       (size_t)KG * BT * 3 * nu);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if ((e = allow_smem(gru_bwd_kernel, smem)) != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_launch(batch, cluster, threads, smem, s, &attr);
  e = cudaLaunchKernelEx(&cfg, gru_bwd_kernel, batch, T, n, nu, (const bf16*)wp,
                         (const bf16*)wtp, (const float*)br, (const float*)gate_in,
                         (const float*)h0, (const float*)hs, (const float*)dhs,
                         (const float*)dhT, (float*)dg, (float*)dzh, (float*)dh0,
                         (float*)dbr_part);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (!want_w) return 0;

  const long long rows = (long long)batch * T;
  long long rpp = (rows + parts - 1) / parts;
  rpp = (rpp + GT_K - 1) / GT_K * GT_K;
  dim3 ggrid((n + GT_M - 1) / GT_M, (n3 + GT_N - 1) / GT_N, parts);
  dwr_kernel<<<ggrid, 256, 0, s>>>(batch, T, n, rpp, (const float*)h0, (const float*)hs,
                                   (const float*)dg, (const float*)dzh, (float*)dwr_part);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int wcount = n * n3;
  reduce_parts_kernel<<<(wcount + 255) / 256, 256, 0, s>>>(wcount, parts,
                                                           (const float*)dwr_part, (float*)dwr);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int bparts = (batch + BT - 1) / BT * BT;
  reduce_parts_kernel<<<(n3 + 255) / 256, 256, 0, s>>>(n3, bparts, (const float*)dbr_part,
                                                       (float*)dbr);
  return (int)cudaGetLastError();
}
