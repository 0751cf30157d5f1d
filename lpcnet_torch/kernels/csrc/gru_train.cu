// K5: the training recurrence of the reset-after GRU over precomputed gate
// inputs, forward and backward.
//
// Replaces the TPU kernels lpcnet_tpu/kernels/gru_train.py::_fwd_kernel and
// ::_bwd_kernel (the custom VJP gru_recurrence). Per step
//   zrec = bf16(h) . bf16(Wr) + br          (f32 sums)
//   z = sigmoid(g_z + zrec_z), r = sigmoid(g_r + zrec_r)
//   hcand = tanh(g_h + r * zrec_h),  h' = z*h + (1-z)*hcand
// with g = gate_in[:, t] = x.kernel + bias[0], computed outside as in the JAX
// package. The backward runs in reverse time from hprev = [h0, hs[:-1]],
// emits dgate_in and dh0, carries dh = d*z + bf16(dzrec) . bf16(Wr^T), and
// accumulates dWr = sum bf16(hprev)^T . bf16(dzrec) and dbr = sum dzrec.
//
// What bounds it on an H100: the chain of T dependent steps. The bytes
// (gate_in read, hs written: 1.9 GB at B=128, T=2400, N=384) and the bf16
// operations are each under a millisecond or two of the card; a step,
// though, is a product with the whole of Wr (0.88 MB in bf16 at N=384) for
// every group of streams, plus barriers.
//
// The forward, by width (kernels/gru_train.py::forward_route): where a rank's
// slice of Wr fits a block's shared memory (48 <= N <= 512, the training
// path's 384 units among them) gru_fwd_chain_kernel (below the backward
// chain): the backward chain's cluster design, Wr resident, the product on
// the tensor cores; above 512 units the first design, gru_fwd_kernel; at
// N <= 32 gru_fwd_warp_kernel. The first design:
// * Streams are independent: a cluster of thread blocks owns 4 streams for
//   all T steps, with no grid sync. The TPU kernel's time blocks, its batch
//   tiles and the padding of small GRUs to 128 lanes are gone: any B, any T,
//   any N that is a multiple of 16 (up to 1024).
// * At N >= 256 the cluster has 4 blocks (4 SMs), each owning a quarter of
//   the units: it sweeps only its quarter of Wr's columns from L2 a step.
//   The new h (rounded to bf16, the operand of the next step) goes to all
//   four blocks through distributed shared memory, double-buffered, behind
//   one cluster barrier a step. A small GRU runs as a cluster of one block.
// * Inside a block the k range of the product is split over 4 thread groups
//   (more loads in flight); the partial sums meet in shared memory, and
//   thread (stream s, unit u) then does the gate arithmetic of its one
//   stream and unit, keeps h in a register and loads the next step's gate
//   inputs a step ahead. Wr is repacked by the wrapper to [N/4][3][N][4]
//   bf16: one 8-byte load brings four k of one gate column.
// * At N <= 32 the forward is a warp-synchronous kernel of its own (below
//   gru_fwd_kernel): no shared memory and no barrier a step.
//
// The backward, in three phases (below the forward):
// 1. The gates depend on hprev alone, not on dh, so they come off the
//    chain: one tensor-core product over all B T rows (gate_pass_kernel),
//    whose epilogue stores z and the four factors that turn d = dh + dhs
//    into dgate_in and dzrec (20 bytes a row and unit, in place of the
//    gradients they become).
// 2. The chain (gru_bwd_chain_kernel): clusters of 8 blocks, Wr's rows of a
//    rank's units resident in shared memory (110.6 KB at N=384), dzrec
//    exchanged through distributed shared memory, the dh product on the
//    tensor cores, one cluster barrier a step.
// 3. dWr is not accumulated inside the time loop: a WMMA kernel forms
//    hprev^T . dzrec over row parts, and a fixed-order reduction adds the
//    parts, and the streams' dbr partials: no float atomics, so two runs
//    give the same bits.

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

__device__ __forceinline__ void store4_bf16(bf16* dst, float4 v) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(v.z, v.w);
}

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

// Thread roles in a forward block of KG * nu threads that owns units
// [rank * nu, (rank + 1) * nu) of its cluster's BT streams:
//   product role  (kg = tid / nu, ul = tid % nu): the kg-th part of the k
//                  range for unit ul, all BT streams;
//   finalize role (fs = tid / nu, ul): stream fs, unit ul (KG == BT).

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// WIDE: blocks of more than 512 threads (N > 512), whose registers the
// compiler must keep within 64 a thread
template <bool WIDE>
__global__ void __launch_bounds__(WIDE ? 1024 : 512) gru_fwd_kernel(int batch, int T, int n, int nu,
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
// backward, phase 3: dWr partials, part p = sum over its rows (b, t) of
// bf16(hprev[row])^T . bf16(dzrec[row]) on the tensor cores
// ---------------------------------------------------------------------------

#define GT_M 128     // tile over hprev units (rows of dWr)
#define GT_N 128     // tile over gate columns
#define GT_K 32      // (b, t) rows per stage
#define GT_LD 136    // padded leading dimension in shared memory

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

  // thread tid loads rows tid / 32 + 8 q of each stage at column
  // (tid % 32) * 4: each row's (b, t) is followed from stage to stage (no
  // division a stage), and a stage's operands are loaded into registers a
  // stage ahead of their use
  const int col = (tid & 31) * 4, j = j0 + col;
  const bool a_on = i0 + col < n, b_on = j < n3;
  long long r[4];
  int bq[4], tq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    r[q] = r_begin + (tid >> 5) + 8 * q;
    bq[q] = (int)(r[q] / T);
    tq[q] = (int)(r[q] - (long long)bq[q] * T);
  }
  float4 av[4], bv[4];
  auto fetch = [&]() {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      av[q] = bv[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r[q] < r_end) {
        if (a_on) {
          const float* src = tq[q] > 0 ? hs + (size_t)(r[q] - 1) * n : h0 + (size_t)bq[q] * n;
          av[q] = *reinterpret_cast<const float4*>(src + i0 + col);
        }
        if (b_on) {
          const float* src = j < 2 * n ? dg + (size_t)r[q] * n3 + j
                                       : dzh + (size_t)r[q] * n + (j - 2 * n);
          bv[q] = *reinterpret_cast<const float4*>(src);
        }
      }
      r[q] += GT_K;
      for (tq[q] += GT_K; tq[q] >= T; tq[q] -= T) ++bq[q];
    }
  };
  fetch();
  for (long long r0 = r_begin; r0 < r_end; r0 += GT_K) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      store4_bf16(As + ((tid >> 5) + 8 * q) * GT_LD + col, av[q]);
      store4_bf16(Bs + ((tid >> 5) + 8 * q) * GT_LD + col, bv[q]);
    }
    __syncthreads();
    if (r0 + GT_K < r_end) fetch();            // in flight during this stage's products
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

// ---------------------------------------------------------------------------
// backward, phase 1: the gate pass, off the dependent chain
// ---------------------------------------------------------------------------
//
// The gates of reverse step t depend only on hprev = [h0, hs[:-1]] (the
// forward's output), not on dh. One product over all B T rows,
// zrec = bf16(hprev) . bf16(Wr) + br, on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 sums), and an epilogue that forms, per row
// and unit, z and the factors that turn d = dh + dhs into the step's
// gradients: dpz = d fz, dpr = d fr, dph = d fh, dzh = d fzh, with
//   fz = (hprev - hcand) z (1 - z),   fh = (1 - z) (1 - hcand^2),
//   fr = fh zrec_h r (1 - r),          fzh = fh r.
// A block takes GP_M rows and GP_U units, i.e. the 3 GP_U gate columns
// [z | r | h] of those units, so that a thread holds all three gates of its
// (row, unit) pairs in its accumulators. The unit tiles are the grid's
// fastest dimension: the blocks of one row tile run together and read its
// hprev rows from L2 once from device memory. fz, fr and fh go where dgate_in's
// three gates will be, fzh where dzh will be, z into a buffer of its own:
// the chain reads each and overwrites it with the gradient in place.

#define GP_M 128     // rows a block
#define GP_U 32      // units a block
#define GP_K 32      // k a stage
#define GP_LD (GP_K + 8)

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b, chained in the tensor core's accumulator
__device__ __forceinline__ void mma_acc(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(256) gate_pass_kernel(
    int batch, int T, int n, const bf16* __restrict__ wrt, const float* __restrict__ br,
    const float* __restrict__ gate_in, const float* __restrict__ h0,
    const float* __restrict__ hs, float* __restrict__ dg, float* __restrict__ dzh,
    float* __restrict__ zb) {
  __shared__ __align__(16) bf16 As[GP_M * GP_LD];        // [row][k] bf16(hprev)
  __shared__ __align__(16) bf16 Bs[3 * GP_U * GP_LD];    // [gate column][k] bf16(Wr^T)
  const long long rows = (long long)batch * T;
  const long long r0 = (long long)blockIdx.y * GP_M;
  const int u0 = blockIdx.x * GP_U, n3 = 3 * n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;     // 4 x 2 warps: 32 rows x 16 units each

  float acc[2][3][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][q][nt][i] = 0.f;

  // A: 128 rows x 32 k a stage, a float4 of each of 4 rows a thread; the
  // rows' hprev sources, found once (a 64-bit division each)
  const int kc = (tid & 7) * 4;
  const float* asrc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + (tid >> 3) + 32 * i;
    const long long b = r / T;
    asrc[i] = r >= rows ? nullptr
                        : (r - b * T > 0 ? hs + (size_t)(r - 1) * n : h0 + (size_t)b * n) + kc;
  }
  // B: 96 columns x 32 k a stage, 16 bytes of one or two columns a thread
  const bf16* bsrc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = (tid + 256 * i) >> 2, u = u0 + c % GP_U;
    bsrc[i] = tid + 256 * i < 3 * GP_U * 4 && u < n
                  ? wrt + (size_t)((c / GP_U) * n + u) * n + (tid & 3) * 8 : nullptr;
  }
  // a stage's operands, loaded into registers a stage ahead of their use
  float4 av[4];
  uint4 bv[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = asrc[i] && k0 + kc < n ? *reinterpret_cast<const float4*>(asrc[i] + k0)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      bv[i] = bsrc[i] && k0 + (tid & 3) * 8 < n ? *reinterpret_cast<const uint4*>(bsrc[i] + k0)
                                                : make_uint4(0u, 0u, 0u, 0u);
  };
  fetch(0);
  for (int k0 = 0; k0 < n; k0 += GP_K) {
#pragma unroll
    for (int i = 0; i < 4; ++i) store4_bf16(As + ((tid >> 3) + 32 * i) * GP_LD + kc, av[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (tid + 256 * i < 3 * GP_U * 4)
        *reinterpret_cast<uint4*>(Bs + ((tid + 256 * i) >> 2) * GP_LD + (tid & 3) * 8) = bv[i];
    __syncthreads();
    if (k0 + GP_K < n) fetch(k0 + GP_K);       // in flight during this stage's products
#pragma unroll
    for (int kk = 0; kk < GP_K; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* ar = As + (wm * 32 + mt * 16 + g) * GP_LD + kk + 2 * t4;
        a[mt][0] = ld32(ar);
        a[mt][1] = ld32(ar + 8 * GP_LD);
        a[mt][2] = ld32(ar + 8);
        a[mt][3] = ld32(ar + 8 * GP_LD + 8);
      }
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const bf16* br_ = Bs + (q * GP_U + wn * 16 + nt * 8 + g) * GP_LD + kk + 2 * t4;
          const uint32_t b0 = ld32(br_), b1 = ld32(br_ + 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_acc(acc[mt][q][nt], a[mt], b0, b1);
        }
    }
    __syncthreads();
  }

  // C fragment: element 2 hf + e at (row g + 8 hf, column 2 t4 + e)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long row = r0 + wm * 32 + mt * 16 + g + 8 * hf;
      if (row >= rows) continue;
      const long long b = row / T;
      const float* hprow = row - b * T > 0 ? hs + (size_t)(row - 1) * n : h0 + (size_t)b * n;
      const float* gi = gate_in + (size_t)row * n3;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = u0 + wn * 16 + nt * 8 + 2 * t4 + e;
          if (u >= n) continue;
          const float zr0 = acc[mt][0][nt][2 * hf + e] + br[u];
          const float zr1 = acc[mt][1][nt][2 * hf + e] + br[n + u];
          const float zr2 = acc[mt][2][nt][2 * hf + e] + br[2 * n + u];
          const float z = sigmoidf_(gi[u] + zr0);
          const float r = sigmoidf_(gi[n + u] + zr1);
          const float hc = tanhf(gi[2 * n + u] + r * zr2);
          const float om = 1.f - z;
          const float fz = (hprow[u] - hc) * (z * om);
          const float fh = om * (1.f - hc * hc);
          const float fr = (fh * zr2) * (r * (1.f - r));
          float* dgr = dg + (size_t)row * n3;
          dgr[u] = fz;
          dgr[n + u] = fr;
          dgr[2 * n + u] = fh;
          dzh[(size_t)row * n + u] = fh * r;
          zb[(size_t)row * n + u] = z;
        }
    }
}

// ---------------------------------------------------------------------------
// backward, phase 2: the dependent chain on a cluster, Wr resident
// ---------------------------------------------------------------------------
//
// dh_{t-1} = d_t z_t + bf16(dzrec_t) . bf16(Wr^T), dzrec_t = d_t [fz | fr | fzh]
// is all that remains sequential. A cluster of C blocks owns S streams (8 or
// 16) for all T steps; rank r owns units [r U, r U + U) (U a multiple of 16,
// units past N padding) and thread (stream s, unit u) keeps dh and its three
// dbr sums in registers. Per step the thread reads its factors and dhs (from
// device memory, two steps ahead in registers: a shared-memory ring, as the
// 16-unit forward has, would need 18.4 KB a step at N=384, S=16, and a step
// is long enough for loads issued two steps ahead to land), forms d and its
// gradients, writes dgate_in and dzh over the factors, and puts its three
// bf16 dzrec entries into the block's copy of the step's rows; the block
// then sends its columns of every stream's row to the other blocks
// (distributed shared memory, 16 bytes a store, each word by a fixed thread,
// double-buffered) behind one cluster barrier a step. (Reading each k
// step's columns from the block that owns them in the product instead, no
// broadcast, made the product several times slower on an H100: remote
// loads in the MMA loop.) Each block then forms dh for its
// own units on the tensor cores: out^T = Wr_rank . dzrec^T, A = the rank's
// U rows of Wr (packed in A-fragment order by the wrapper, kept in shared
// memory where they fit, else read from L2), B = dzrec rows (k = 3N deep).
// Warp w takes one 16-unit
// tile, all S streams (each A fragment read once a step and used for the
// S / 8 stream tiles) and one of S / 2 parts of the k steps; each k step is
// summed by the tensor core from zero and added to the running sum in IEEE
// float32, and the parts meet in shared memory in a fixed order.
template <int S>
__global__ void __launch_bounds__(1024, 1) gru_bwd_chain_kernel(
    int batch, int T, int n, int U, int resident, const uint4* __restrict__ wb,
    const float* __restrict__ dhs, const float* __restrict__ dhT, float* dg, float* dzh,
    const float* zb, float* __restrict__ dh0, float* __restrict__ dbr_part) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n3 = 3 * n, ldz = n3 + 8, KS = n3 / 16, MT = U / 16;
  constexpr int KP = S / 2, NTS = S / 8;   // k parts, stream tiles
  const size_t wwords = (size_t)MT * KS * 32;
  extern __shared__ __align__(16) unsigned char csmem[];
  uint4* ws = reinterpret_cast<uint4*>(csmem);
  bf16* dz = reinterpret_cast<bf16*>(csmem + (resident ? wwords * 16 : 0));  // [2][S][ldz]
  float* part = reinterpret_cast<float*>(dz + 2 * S * ldz);                  // [KP][S][U]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = tid / U, ul = tid % U, u = rank * U + ul;
  const int b = (blockIdx.x / C) * S + s;
  const bool own = u < n, on = own && b < batch;
  const uint4* wg = wb + (size_t)rank * wwords;

  if (resident)
    for (size_t i = tid; i < wwords; i += blockDim.x) ws[i] = wg[i];
  for (int i = tid; i < S * ldz; i += blockDim.x) dz[i] = dz[S * ldz + i] = __float2bfloat16_rn(0.f);

  struct Fac { float z, fz, fr, fh, fzh, dv; };
  auto load = [&](int t) {
    Fac f = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (on && t >= 0) {
      const size_t row = (size_t)b * T + t;
      f.z = zb[row * n + u];
      f.fz = dg[row * n3 + u];
      f.fr = dg[row * n3 + n + u];
      f.fh = dg[row * n3 + 2 * n + u];
      f.fzh = dzh[row * n + u];
      f.dv = dhs[row * n + u];
    }
    return f;
  };
  float dh = on ? dhT[(size_t)b * n + u] : 0.f;
  float dbr0 = 0.f, dbr1 = 0.f, dbr2 = 0.f;
  Fac f0 = load(T - 1), f1 = load(T - 2);
  const int mt = warp % MT, kp = warp / MT;          // warps = MT x KP
  const int ks0 = kp * KS / KP, ks1 = (kp + 1) * KS / KP;
  const int g = lane >> 2, t4 = lane & 3;
  // the broadcast: the rank's 16-byte words of a step's rows (gate q,
  // stream, 8 units), each sent to a fixed set of the other ranks by a
  // fixed thread: word tid % W to ranks rank + 1 + tid / W + P i
  const int wpr = max(0, min(U, n - rank * U)) / 8;  // words of one gate's real units
  const int W = 3 * S * wpr, P = (int)blockDim.x / max(W, 1);
  const int wj = tid % max(W, 1);
  const int woff =
      W > 0 ? ((wj / wpr) % S) * ldz + (wj / (S * wpr)) * n + rank * U + (wj % wpr) * 8 : 0;
  const bool sends = W > 0 && tid < P * W;
  cluster.sync();   // every block is set up before remote stores

  for (int t = T - 1; t >= 0; --t) {
    const Fac f2 = load(t - 2);
    const float d = dh + f0.dv;
    const float dpz = d * f0.fz, dpr = d * f0.fr, dph = d * f0.fh, dzv = d * f0.fzh;
    if (on) {
      const size_t row = (size_t)b * T + t;
      dg[row * n3 + u] = dpz;
      dg[row * n3 + n + u] = dpr;
      dg[row * n3 + 2 * n + u] = dph;
      dzh[row * n + u] = dzv;
    }
    dbr0 += dpz;
    dbr1 += dpr;
    dbr2 += dzv;
    const float dkeep = d * f0.z;
    bf16* buf = dz + (t & 1) * S * ldz;
    if (own) {
      bf16* zrow = buf + s * ldz;
      zrow[u] = __float2bfloat16_rn(dpz);
      zrow[n + u] = __float2bfloat16_rn(dpr);
      zrow[2 * n + u] = __float2bfloat16_rn(dzv);
    }
    __syncthreads();
    if (sends) {
      const uint4 v = *reinterpret_cast<const uint4*>(buf + woff);
      for (int c = 1 + tid / W; c < C; c += P)
        *reinterpret_cast<uint4*>(cluster.map_shared_rank(buf, (rank + c) % C) + woff) = v;
    }
    // dzrec is complete in every block; the buffer alternates with t, so no
    // block a step ahead overwrites what another still reads
    step_barrier(cluster, C);

    float acc[NTS][4] = {};
    const bf16* xr = buf + g * ldz + 2 * t4;
    auto product = [&](const uint4* wf) {
#pragma unroll 2
      for (int k = ks0; k < ks1; ++k) {
        const uint4 a = wf[k * 32];
        const uint32_t av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int nt = 0; nt < NTS; ++nt) {
          const bf16* x = xr + nt * 8 * ldz + k * 16;
          float dd[4] = {0.f, 0.f, 0.f, 0.f};
          mma_acc(dd, av, ld32(x), ld32(x + 8));
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] += dd[i];
        }
      }
    };
    if (resident) product(ws + (size_t)mt * KS * 32 + lane);
    else product(wg + (size_t)mt * KS * 32 + lane);
    // D fragment: c0, c1 at (unit g, streams 2 t4, 2 t4 + 1); c2, c3 at unit g + 8
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
      float* pp = part + (kp * S + nt * 8 + 2 * t4) * U + mt * 16 + g;
      pp[0] = acc[nt][0];
      pp[U] = acc[nt][1];
      pp[8] = acc[nt][2];
      pp[U + 8] = acc[nt][3];
    }
    __syncthreads();
    const float* q = part + s * U + ul;
    float sum = q[0];
#pragma unroll
    for (int i = 1; i < KP; ++i) sum += q[i * S * U];
    dh = dkeep + sum;
    f0 = f1;
    f1 = f2;
    // the next step's first barrier comes before `part` changes
  }
  if (on) dh0[(size_t)b * n + u] = dh;
  if (own) {                        // one dbr partial per stream slot
    float* out = dbr_part + (size_t)b * n3;
    out[u] = dbr0;
    out[n + u] = dbr1;
    out[2 * n + u] = dbr2;
  }
}

// ---------------------------------------------------------------------------
// forward on a cluster, Wr resident
// ---------------------------------------------------------------------------
//
// The backward chain's design applied to the forward, where the slice fits
// a block's shared memory (fwd_launch_config in kernels/gru_train.py: up to
// N = 512; above it gru_fwd_kernel, at N <= 32 gru_fwd_warp_kernel). A
// cluster of C blocks owns S streams (8 or 16) for all T steps; rank r owns
// units [r U, r U + U) (bwd_cluster_shape: C = 8, U = 48 at N = 384; units
// past N are padding with zero weights whose h stays 0) and keeps Wr's 3U
// columns of its units (all N rows) in shared memory: 110.6 KB in bf16 at
// N = 384, packed by the wrapper in the A-fragment order of mma.sync
// m16n8k16 (pack_fwd_weights). Per step:
// * the product zrec^T = Wr_rank^T . bf16(h)^T on the tensor cores: A = the
//   slice (16 gate columns a tile), B = the bf16 operand rows of h (8
//   streams a tile, double-buffered, [S][C U + 8]); warp w takes one column
//   tile, both stream tiles (each A fragment read once a step) and one of KP
//   parts of the k steps; each k step is summed by the tensor core from zero
//   and added to the running sum in IEEE float32 (the chained accumulation
//   does not round to nearest, and a forward carries its error 2400 steps),
//   and the parts meet in shared memory in a fixed order;
// * thread (stream s, unit u) adds br, does the gate arithmetic of its own
//   (stream, unit) with the gate inputs it loaded two steps ahead in
//   registers, keeps h in float32 in a register and writes hs;
// * the new bf16 h goes to every block: the 8 lanes that hold 8 consecutive
//   units of one stream gather them into one 16-byte word by shuffles and
//   lane c of the 8 stores it into rank c's copy (distributed shared
//   memory), so there is no block barrier before the exchange; then one
//   cluster barrier, split into arrive and wait around the store of hs.
// The arithmetic is the first cluster kernel's: bf16 operands, f32 sums,
// reset-after gates, br added to the recurrent sums. What is left of a step
// (tools/trace_k5_chain_torch.py on an H100 at N = 384: about 6,600 cycles)
// is the product, which reads the whole slice from shared memory every
// step, and the exchange: the remote stores and the barrier's release,
// which waits for them to land, about a third each.

// k parts of the product (kernels/gru_train.py::fwd_kparts): as many as
// the block's warps give every column tile, at most the k steps
__host__ __device__ inline int fwd_kparts(int n, int units, int streams) {
  const int warps = streams * units / 32, mt = 3 * units / 16;
  const int kp = warps / mt < n / 16 ? warps / mt : n / 16;
  return kp > 1 ? kp : 1;
}

template <int S>
__global__ void __launch_bounds__(1024, 1) gru_fwd_chain_kernel(
    int batch, int T, int n, int U, const uint4* __restrict__ wb, const float* __restrict__ br,
    const float* __restrict__ gate_in, const float* __restrict__ h0, float* __restrict__ hs,
    float* __restrict__ hT) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n3 = 3 * n, ldx = C * U + 8, ldp = 3 * U + 4, KS = n / 16, MT = 3 * U / 16;
  const int KP = fwd_kparts(n, U, S);
  constexpr int NTS = S / 8;                          // stream tiles
  const size_t wwords = (size_t)MT * KS * 32;
  extern __shared__ __align__(16) unsigned char fsmem[];
  uint4* ws = reinterpret_cast<uint4*>(fsmem);                          // the slice
  bf16* hop = reinterpret_cast<bf16*>(fsmem + wwords * 16);             // [2][S][ldx]
  float* part = reinterpret_cast<float*>(hop + 2 * S * ldx);            // [KP][S][ldp]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = tid / U, ul = tid % U, u = rank * U + ul;
  const int b0 = (blockIdx.x / C) * S, b = b0 + s;
  const bool own = u < n, on = own && b < batch;

  const uint4* wg = wb + (size_t)rank * wwords;
  for (size_t i = tid; i < wwords; i += blockDim.x) ws[i] = wg[i];
  // buffer 0: every block's own copy of bf16(h0); buffer 1 zero
  for (int i = tid; i < 2 * S * ldx; i += blockDim.x) {
    const int ss = i / ldx, k = i % ldx;
    const bool in = ss < S && k < n && b0 + ss < batch;
    hop[i] = __float2bfloat16_rn(in ? h0[(size_t)(b0 + ss) * n + k] : 0.f);
  }
  float h = on ? h0[(size_t)b * n + u] : 0.f;
  float brv[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) brv[q] = own ? br[q * n + u] : 0.f;
  struct Gin { float z, r, h; };
  auto load = [&](int t) {
    Gin g = {0.f, 0.f, 0.f};
    if (on && t < T) {
      const float* p = gate_in + ((size_t)b * T + t) * n3 + u;
      g.z = p[0];
      g.r = p[n];
      g.h = p[2 * n];
    }
    return g;
  };
  Gin g0 = load(0), g1 = load(1);
  const int mt = warp % MT, kp = warp / MT;
  const bool prod = kp < KP;
  const int ks0 = kp * KS / KP, ks1 = (kp + 1) * KS / KP;
  const int g = lane >> 2, t4 = lane & 3;
  // the exchange word of this lane's group of 8 (stream s, units from
  // u - c), and the rank it goes to
  const int c = lane & 7, woff = s * ldx + u - c;
  cluster.sync();   // every block is set up before remote stores

  for (int t = 0; t < T; ++t) {
    const Gin g2 = load(t + 2);
    const bf16* cur = hop + (t & 1) * S * ldx;
    bf16* nxt = hop + ((t + 1) & 1) * S * ldx;
    if (prod) {
      float acc[NTS][4] = {};
      const uint4* wf = ws + (size_t)mt * KS * 32 + lane;
      const bf16* xr = cur + g * ldx + 2 * t4;
#pragma unroll 2
      for (int k = ks0; k < ks1; ++k) {
        const uint4 a = wf[k * 32];
        const uint32_t av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int nt = 0; nt < NTS; ++nt) {
          const bf16* x = xr + nt * 8 * ldx + k * 16;
          float dd[4] = {0.f, 0.f, 0.f, 0.f};
          mma_acc(dd, av, ld32(x), ld32(x + 8));
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] += dd[i];
        }
      }
      // D fragment: c0, c1 at (gate column g, streams 2 t4, 2 t4 + 1); c2, c3 at column g + 8
#pragma unroll
      for (int nt = 0; nt < NTS; ++nt) {
        float* pp = part + (kp * S + nt * 8 + 2 * t4) * ldp + mt * 16 + g;
        pp[0] = acc[nt][0];
        pp[ldp] = acc[nt][1];
        pp[8] = acc[nt][2];
        pp[ldp + 8] = acc[nt][3];
      }
    }
    __syncthreads();
    float zr[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float* pq = part + s * ldp + q * U + ul;
      float a = pq[0];
      for (int i = 1; i < KP; ++i) a += pq[i * S * ldp];
      zr[q] = a + brv[q];
    }
    if (own) {
      const float z = sigmoid_rcp(g0.z + zr[0]);
      const float r = sigmoid_rcp(g0.r + zr[1]);
      const float hc = tanhf(g0.h + r * zr[2]);
      h = z * h + (1.f - z) * hc;
    }
    // the new operand: lanes 8j .. 8j+7 hold 8 consecutive units of one
    // stream (U is a multiple of 16); even lanes pair their value with the
    // next lane's, every lane of the group gathers the four pairs
    const uint32_t mine = __bfloat16_as_ushort(__float2bfloat16_rn(h));
    const uint32_t pair = mine | (__shfl_down_sync(0xffffffffu, mine, 1) << 16);
    const int base = lane & ~7;
    uint4 v;
    v.x = __shfl_sync(0xffffffffu, pair, base);
    v.y = __shfl_sync(0xffffffffu, pair, base + 2);
    v.z = __shfl_sync(0xffffffffu, pair, base + 4);
    v.w = __shfl_sync(0xffffffffu, pair, base + 6);
    if (c < C) *reinterpret_cast<uint4*>(cluster.map_shared_rank(nxt, c) + woff) = v;
    // the cluster barrier: h's operand complete in every block, and the
    // buffer the next step writes no longer read; hs is stored meanwhile
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    if (on) hs[((size_t)b * T + t) * n + u] = h;
    g0 = g1;
    g1 = g2;
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
  if (on) hT[(size_t)b * n + u] = h;
}

typedef void (*FwdChainKernel)(int, int, int, int, const uint4*, const float*, const float*,
                               const float*, float*, float*);

FwdChainKernel fwd_chain_kernel_for(int streams) {
  return streams == 8 ? gru_fwd_chain_kernel<8>
                      : (streams == 16 ? gru_fwd_chain_kernel<16> : nullptr);
}

// the resident forward's shared memory (kernels/gru_train.py::fwd_smem_bytes
// computes the same): the rank's slice (3U x N bf16), the operand of h
// [2][S][C U + 8] bf16, the k parts' sums [KP][S][3U + 4] f32
size_t fwd_chain_smem(int n, int cluster, int units, int streams) {
  return (size_t)3 * units * n * 2 + (size_t)2 * streams * (cluster * units + 8) * 2 +
         (size_t)fwd_kparts(n, units, streams) * streams * (3 * units + 4) * 4;
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

// grid of ceil(batch / streams) clusters of `cluster` blocks each
cudaLaunchConfig_t cluster_launch(int batch, int streams, int cluster, int threads, size_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((batch + streams - 1) / streams) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

typedef void (*ChainKernel)(int, int, int, int, int, const uint4*, const float*, const float*,
                            float*, float*, const float*, float*, float*);

ChainKernel chain_kernel_for(int streams) {
  return streams == 8 ? gru_bwd_chain_kernel<8> : (streams == 16 ? gru_bwd_chain_kernel<16> : nullptr);
}

// the chain's shared memory (kernels/gru_train.py::bwd_smem_bytes computes
// the same): the rank's packed rows of Wr where resident, dzrec [2][S][3N+8]
// bf16, the k parts' sums [S/2][S][U] f32
size_t chain_smem(int n, int units, int streams, int resident) {
  return (resident ? (size_t)units * 3 * n * 2 : 0) + (size_t)2 * streams * (3 * n + 8) * 2 +
         (size_t)(streams / 2) * streams * units * 4;
}

bool bad_chain(int n, int cluster, int units, int streams) {
  return n <= 0 || n % 16 != 0 || n > 1024 || cluster < 1 || cluster > 8 || units % 16 != 0 ||
         cluster * units < n || !chain_kernel_for(streams) || streams * units > 1024;
}

}  // namespace

extern "C" int lpcnet_gru_train_fwd(int batch, int T, int n, int cluster, int threads,
                                    const void* wp, const void* br, const void* gate_in,
                                    const void* h0, void* hs, void* hT, void* stream) {
  if (bad_config(batch, T, n, cluster, threads)) return (int)cudaErrorInvalidValue;
  const int nu = n / cluster;
  const size_t smem = sizeof(float) * ((size_t)2 * BT * n + (size_t)KG * BT * 3 * nu);
  cudaError_t e;
  auto k = threads > 512 ? gru_fwd_kernel<true> : gru_fwd_kernel<false>;
  if ((e = allow_smem(k, smem)) != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_launch(batch, BT, cluster, threads, smem,
                                          (cudaStream_t)stream, &attr);
  e = cudaLaunchKernelEx(&cfg, k, batch, T, n, nu, (const bf16*)wp,
                         (const float*)br, (const float*)gate_in, (const float*)h0,
                         (float*)hs, (float*)hT);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The forward with Wr resident across a cluster (gru_fwd_chain_kernel):
// clusters of `cluster` blocks of `units` units, `streams` streams each; wf
// the ranks' packed slices (kernels/gru_train.py::pack_fwd_weights); smem
// the layout's total (fwd_smem_bytes).
extern "C" int lpcnet_gru_train_fwd_chain(int batch, int T, int n, int cluster, int units,
                                          int streams, int smem, const void* wf, const void* br,
                                          const void* gate_in, const void* h0, void* hs, void* hT,
                                          void* stream) {
  const FwdChainKernel k = fwd_chain_kernel_for(streams);
  if (batch <= 0 || T <= 0 || !k || bad_chain(n, cluster, units, streams) ||
      (size_t)smem != fwd_chain_smem(n, cluster, units, streams))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_launch(batch, streams, cluster, streams * units, smem,
                                          (cudaStream_t)stream, &attr);
  e = cudaLaunchKernelEx(&cfg, k, batch, T, n, units, (const uint4*)wf, (const float*)br,
                         (const float*)gate_in, (const float*)h0, (float*)hs, (float*)hT);
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

// The backward's gate pass alone (phase 1 of lpcnet_gru_train_bwd), for
// holding it against its plain version: z into zb, fz, fr, fh into dg's
// three gates, fzh into dzh.
extern "C" int lpcnet_gru_gate_pass(int batch, int T, int n, const void* wrt, const void* br,
                                    const void* gate_in, const void* h0, const void* hs,
                                    void* dg, void* dzh, void* zb, void* stream) {
  if (batch <= 0 || T <= 0 || n <= 0 || n % 16 != 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)batch * T;
  dim3 pgrid((n + GP_U - 1) / GP_U, (unsigned)((rows + GP_M - 1) / GP_M));
  gate_pass_kernel<<<pgrid, 256, 0, (cudaStream_t)stream>>>(
      batch, T, n, (const bf16*)wrt, (const float*)br, (const float*)gate_in,
      (const float*)h0, (const float*)hs, (float*)dg, (float*)dzh, (float*)zb);
  return (int)cudaGetLastError();
}

// The most clusters of the backward chain's shape (fwd == 0) or of the
// resident forward's (fwd == 1) the card holds at once; a negative CUDA
// error code on failure.
extern "C" int lpcnet_gru_max_clusters(int fwd, int streams, int cluster, int threads, int smem) {
  const void* k = fwd ? (const void*)fwd_chain_kernel_for(streams)
                      : (const void*)chain_kernel_for(streams);
  if (!k || (fwd != 0 && fwd != 1)) return -(int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_launch(64 * streams, streams, cluster, threads, smem, 0, &attr);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, k, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

// The backward: the gate pass, the chain (clusters of `cluster` blocks of
// `units` units, `streams` streams each; wb the packed rows of Wr, resident
// in shared memory if `resident`; wrt bf16 Wr^T [3n][n]), then, with
// want_w, dWr (`parts` row parts) and dbr. dg [B][T][3n], dzh and zb
// [B][T][n] are written by the gate pass and overwritten by the chain;
// dbr_part is [ceil(batch / streams) * streams][3n]; dwr_part is
// [parts][n][3n]. With want_w == 0 only dg, dzh and dh0 are produced.
extern "C" int lpcnet_gru_train_bwd(int batch, int T, int n, int cluster, int units, int streams,
                                    int smem, int resident, const void* wb, const void* wrt,
                                    const void* br, const void* gate_in, const void* h0,
                                    const void* hs, const void* dhs, const void* dhT, void* dg,
                                    void* dzh, void* zb, void* dh0, void* dbr_part, int want_w,
                                    int parts, void* dwr_part, void* dwr, void* dbr,
                                    void* stream) {
  if (batch <= 0 || T <= 0 || bad_chain(n, cluster, units, streams) ||
      (size_t)smem != chain_smem(n, units, streams, resident) || (want_w && parts <= 0))
    return (int)cudaErrorInvalidValue;
  const int n3 = 3 * n;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  const long long rows = (long long)batch * T;
  dim3 pgrid((n + GP_U - 1) / GP_U, (unsigned)((rows + GP_M - 1) / GP_M));
  gate_pass_kernel<<<pgrid, 256, 0, s>>>(batch, T, n, (const bf16*)wrt, (const float*)br,
                                         (const float*)gate_in, (const float*)h0,
                                         (const float*)hs, (float*)dg, (float*)dzh, (float*)zb);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const ChainKernel k = chain_kernel_for(streams);
  if ((e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_launch(batch, streams, cluster, streams * units, smem, s, &attr);
  e = cudaLaunchKernelEx(&cfg, k, batch, T, n, units, resident, (const uint4*)wb,
                         (const float*)dhs, (const float*)dhT, (float*)dg, (float*)dzh,
                         (const float*)zb, (float*)dh0, (float*)dbr_part);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (!want_w) return 0;

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
  const int slots = (batch + streams - 1) / streams * streams;
  reduce_parts_kernel<<<(n3 + 255) / 256, 256, 0, s>>>(n3, slots, (const float*)dbr_part,
                                                       (float*)dbr);
  return (int)cudaGetLastError();
}
