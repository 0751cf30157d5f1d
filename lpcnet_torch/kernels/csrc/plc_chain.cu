// K4: K masked steps of the PLC feature-prediction network in one launch,
// redesigned for Hopper.
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
// What bounds it on an H100: the float32 multiply-adds (0.70 M a step and
// stream, 0.72 G at 256 streams and 4 steps: 21 us at the card's 67 TFLOP/s
// outside the tensor cores) and the weights' reads. The first design gave
// each block two streams and swept all 2.8 MB of weights from L2 every
// step, ~1.4 GB of L2 reads a launch at 256 streams, two streams served by
// each read.
//
// What this design does about it:
// * A cluster of C = 8 blocks owns S streams (8, 16 or 32:
//   kernels/plc_chain.py::chain_launch_config). An H100 holds 15 such
//   clusters at one block an SM, so 256 streams take 8 clusters of 32.
//   Rank r owns 1/C of every layer's output units: nd / C of the dense
//   layer's, n1 / C of GRU-1's and n2 / C of GRU-2's with their three gate
//   columns, input and recurrent parts apart as the reset gate needs, and
//   outputs r, r + C, r + 2C, ... of the last dense layer. Its GRU weights
//   are packed rank-contiguous (plc_chain.py::pack_chain_weights, rows
//   padded to 3U + 8 floats), 364 KB at C = 8, and read from L2 once a step
//   for all S streams: 0.09 GB of L2 reads a launch at 256 streams. Its
//   dense units' weights, its output columns and its biases (8 KB) stay in
//   shared memory.
// * The GRU weights stream through a ring of 2-4 chunks of 48-64 rows in
//   shared memory, each filled by one TMA bulk copy (cp.async.bulk, the
//   packed rows are contiguous) that completes on the stage's "full"
//   mbarrier; each warp arrives on the stage's "empty" mbarrier when done
//   with it, and warp 0 refills it then. The copies of the next chunks are
//   in flight while the block computes on the current one, and across the
//   barriers between phases and steps. Each chunk costs its waits, so the
//   ring takes the largest chunks that fit (48 rows at S = 32). Threads
//   that each streamed their own weights with 16-byte loads from L2 reached
//   ~7 bytes a cycle an SM, ~23 us a step whatever S.
// * Each GRU product is out[c][s] = sum_k x[k][s] W[k][c] over the rank's
//   3U columns: a thread owns a tile of 4 streams x 4 columns (16 FMAs per
//   16-byte weight load and 16-byte operand load, both from shared memory)
//   and every KP-th k; the KP lanes of a tile then sum their parts by
//   shuffles, in a fixed order (no atomics: two runs are bit-equal).
// * After each GRU, a rank's new candidate slice goes to every rank over
//   distributed shared memory, 16 bytes a store, behind one cluster
//   barrier: two a step. Every rank keeps the whole state of both GRUs and
//   masks it itself. The dense layer of step k+1 depends on the inputs
//   only, so it runs beside GRU-2's products of step k and its slice rides
//   on GRU-2's exchange.
// Plain FMAs in float32 on the CUDA cores: no tensor cores, no TF32, so the
// result is within rounding of the plain PyTorch version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#define K4_THREADS 384
#define K4_CLUSTER 8
#define K4_PAD 8          // floats of padding a packed row (conflict-free reads)
#define K4_BARS 64        // bytes of mbarriers at the start of shared memory (two a stage)
#define K4_CHUNKS 60      // most chunks a step: their descriptors follow
#define K4_HEAD (K4_BARS + 16 * K4_CHUNKS)

struct ChainArgs {
  int batch, k_steps, n_in, nd, n1, n2, n_out;
  const float* d1_w;    // packed [C][n_in][nd / C]
  const float* d1_b;    // [nd]
  const float* g1_in;   // packed [C][nd][3 n1 / C + 8]
  const float* g1_rec;  // packed [C][n1][3 n1 / C + 8]
  const float* g1_b;    // [2, 3n1]
  const float* g2_in;   // packed [C][n1][3 n2 / C + 8]
  const float* g2_rec;  // packed [C][n2][3 n2 / C + 8]
  const float* g2_b;    // [2, 3n2]
  const float* out_w;   // [n2, n_out]
  const float* out_b;   // [n_out]
  const float* inputs;  // [B, K, n_in]
  const int* masks;     // [B, K]
  const float* h1_in; const float* h2_in;      // [B, n1], [B, n2]
  float* h1_seq; float* h2_seq; float* outs;   // [B, K, n1], [B, K, n2], [B, K, n_out]
  int nst, rows;                               // chunks in the ring, rows a chunk
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The ring that streams a rank's GRU weights: per step the chunks of its
// four packed matrices (rows of 3U + 8 floats) in the order the products
// read them (GRU-1 input, GRU-1 recurrent, GRU-2 input, GRU-2 recurrent),
// chunk c in stage c % nst, each one bulk copy of whole rows.
struct ChunkDesc {
  const float* src;
  int bytes, pad;
};

struct Ring {
  float* buf;                   // [nst][rows][ld]
  unsigned long long* full;     // [nst] mbarriers: a chunk has landed
  unsigned long long* empty;    // [nst] mbarriers: every warp is done with a chunk
  const ChunkDesc* desc;        // [per_step]
  int nst, rows, ld, per_step, total;
};

// chunk c into its stage, by one thread: the mbarrier's byte count, then
// the copy (every warp has released the stage's previous chunk)
__device__ __forceinline__ void ring_issue(const Ring& R, int c) {
  if (c >= R.total) return;
  const ChunkDesc d = R.desc[c % R.per_step];
  const int st = c % R.nst;
  const uint32_t bar = smem_u32(R.full + st);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(d.bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(R.buf + (size_t)st * R.rows * R.ld)), "l"(d.src), "r"(d.bytes), "r"(bar)
      : "memory");
}

// wait for the phase of mbarrier `bars[c % nst]` that chunk c completes
__device__ __forceinline__ void bar_wait(const unsigned long long* bars, int nst, int c) {
  const uint32_t bar = smem_u32(bars + c % nst), parity = (c / nst) & 1;
  uint32_t done = 0;
  do {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// warp 0, before it reads chunk c: once every warp is done with chunk c - 1,
// that chunk's stage takes chunk c - 1 + nst
__device__ __forceinline__ void ring_refill(const Ring& R, int c, int lane) {
  if (c == 0) return;
  if (lane == 0) {
    bar_wait(R.empty, R.nst, c - 1);
    ring_issue(R, c - 1 + R.nst);
  }
  __syncwarp();
}

// every warp, after it has read chunk c
__device__ __forceinline__ void ring_release(const Ring& R, int c, int lane) {
  __syncwarp();
  if (lane == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(R.empty + c % R.nst)) : "memory");
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// the k parts a tile of 4 streams x 4 columns of an nc-column product is
// cut into, so that the tiles and their parts fill the block; 0 where they
// cannot in a power of two of at most 32 parts (within a warp)
// (kernels/plc_chain.py::k_parts computes the same)
__host__ __device__ inline int k_parts(int nc, int s) {
  const int tiles = (nc / 4) * (s / 4);
  if (nc % 4 || tiles == 0 || K4_THREADS % tiles) return 0;
  const int kp = K4_THREADS / tiles;
  return kp <= 32 && (kp & (kp - 1)) == 0 ? kp : 0;
}

// out[c][s] = sum_k x[k][s] w[k][c], c < nc, s < S; x [K][S] and out [nc][S]
// in shared memory, w [K][nc + 8] (a rank's packed columns) the ring's next
// ceil(K / rows) chunks, cc the ring's chunk counter. Thread tid takes
// part kp = tid % KP of tile tid / KP: streams 4 sq .. 4 sq + 3 and columns
// 4 cq .. 4 cq + 3, k = kp, kp + KP, ...; the KP lanes of a tile are
// neighbours, and their sums meet by shuffles in a fixed order. Each warp
// releases a chunk when it is done with it; warp 0 refills a stage once
// every warp has released it.
template <int S>
__device__ __forceinline__ void product(const Ring& R, int& cc, int K, int nc, const float* x,
                                        float* out, int tid) {
  const int KP = k_parts(nc, S);
  const int kp = tid % KP, tile = tid / KP;
  const int sq = tile % (S / 4), cq = tile / (S / 4);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* xp = x + 4 * sq;
  const int ld = nc + K4_PAD;
  const int lane = tid & 31;
  for (int r0 = 0; r0 < K; r0 += R.rows, ++cc) {
    if (tid < 32) ring_refill(R, cc, lane);
    if (lane == 0) bar_wait(R.full, R.nst, cc);     // one poller a warp
    __syncwarp();
    const float* wst = R.buf + (size_t)(cc % R.nst) * R.rows * R.ld + 4 * cq;
    const int rows = min(R.rows, K - r0);
#pragma unroll 4
    for (int r = kp; r < rows; r += KP) {
      const float4 wv = *reinterpret_cast<const float4*>(wst + r * ld);
      const float4 xv = *reinterpret_cast<const float4*>(xp + (r0 + r) * S);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w}, ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ws[j], acc[i][j]);
    }
    ring_release(R, cc, lane);
  }
  for (int off = 1; off < KP; off <<= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
  if (kp == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(out + (4 * cq + j) * S + 4 * sq) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
}

// rows [row0, row0 + rows) of a [.][S] buffer, from this block to every
// other block of the cluster, 16 bytes a store
template <int S>
__device__ __forceinline__ void send_rows(cg::cluster_group& cluster, float* buf, int row0,
                                          int rows, int rank, int tid) {
  const int words = rows * S / 4;
  float4* src = reinterpret_cast<float4*>(buf + row0 * S);
  for (int i = tid; i < (K4_CLUSTER - 1) * words; i += K4_THREADS) {
    const int c = (rank + 1 + i / words) % K4_CLUSTER, w = i % words;
    cluster.map_shared_rank(src, c)[w] = src[w];
  }
}

template <int S>
__global__ void __launch_bounds__(K4_THREADS, 1) chain_cluster_kernel(ChainArgs p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int b0 = (blockIdx.x / K4_CLUSTER) * S;
  const int nact = min(S, p.batch - b0);
  const int K = p.k_steps, n_in = p.n_in, nd = p.nd, n1 = p.n1, n2 = p.n2, n_out = p.n_out;
  const int ud = nd / K4_CLUSTER, u1 = n1 / K4_CLUSTER, u2 = n2 / K4_CLUSTER;
  const int nc1 = 3 * u1, nc2 = 3 * u2;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_raw);  // [nst]
  unsigned long long* empty = full + K4_BARS / 16;                              // [nst]
  ChunkDesc* desc = reinterpret_cast<ChunkDesc*>(smem_raw + K4_BARS);          // [K4_CHUNKS]
  float* dbuf = reinterpret_cast<float*>(smem_raw + K4_HEAD);  // [nd][S] dense output
  float* h1 = dbuf + nd * S;           // [n1][S] GRU-1's state (masked)
  float* h1n = h1 + n1 * S;            // [n1][S] its candidate
  float* h2 = h1n + n1 * S;            // [n2][S]
  float* h2n = h2 + n2 * S;
  float* gi = h2n + n2 * S;            // [max(nc1, nc2)][S] GRU-1's, then GRU-2's
  float* gr = gi + max(nc1, nc2) * S;  // input and recurrent products
  float* xin = gr + max(nc1, nc2) * S; // [n_in][S] the next dense layer's input
  int* msk = reinterpret_cast<int*>(xin + n_in * S);   // [S] the step's masks
  // this rank's small weights, resident: the dense layer's units, its
  // output columns, the biases of its units
  const int no = (n_out - rank + K4_CLUSTER - 1) / K4_CLUSTER;   // its outputs
  const int nom = (n_out + K4_CLUSTER - 1) / K4_CLUSTER;
  float* d1_w = reinterpret_cast<float*>(msk + S);     // [n_in][ud]
  float* ow = d1_w + n_in * ud;                        // [n2][nom] outputs r, r + C, ..
  float* gb1 = ow + n2 * nom;                          // [2][nc1] GRU-1's biases
  float* gb2 = gb1 + 2 * nc1;                          // [2][nc2]
  float* db = gb2 + 2 * nc2;                           // [ud]
  float* ob = db + ud;                                 // [nom]
  for (int i = tid; i < n_in * ud; i += K4_THREADS) d1_w[i] = p.d1_w[(size_t)rank * n_in * ud + i];
  for (int i = tid; i < n2 * no; i += K4_THREADS)
    ow[(i / no) * nom + i % no] = p.out_w[(i / no) * n_out + rank + K4_CLUSTER * (i % no)];
  auto gru_bias = [&](float* dst, const float* bias, int n, int u) {
    for (int i = tid; i < 6 * u; i += K4_THREADS) {      // [in | rec] x (gate q, unit j)
      const int part = i / (3 * u), lc = i % (3 * u);
      dst[i] = bias[part * 3 * n + (lc / u) * n + rank * u + lc % u];
    }
  };
  gru_bias(gb1, p.g1_b, n1, u1);
  gru_bias(gb2, p.g2_b, n2, u2);
  for (int i = tid; i < ud; i += K4_THREADS) db[i] = p.d1_b[rank * ud + i];
  for (int i = tid; i < no; i += K4_THREADS) ob[i] = p.out_b[rank + K4_CLUSTER * i];

  // the ring, after the small weights, 16-byte aligned, and its chunks'
  // descriptors
  Ring R;
  R.buf = reinterpret_cast<float*>(
      smem_raw + ((reinterpret_cast<unsigned char*>(ob + nom) - smem_raw + 15) & ~15));
  R.full = full;
  R.empty = empty;
  R.desc = desc;
  R.nst = p.nst;
  R.rows = p.rows;
  R.ld = max(nc1, nc2) + K4_PAD;
  {
    const float* segs[4] = {p.g1_in + (size_t)rank * nd * (nc1 + K4_PAD),
                            p.g1_rec + (size_t)rank * n1 * (nc1 + K4_PAD),
                            p.g2_in + (size_t)rank * n1 * (nc2 + K4_PAD),
                            p.g2_rec + (size_t)rank * n2 * (nc2 + K4_PAD)};
    const int seg_rows[4] = {nd, n1, n1, n2}, seg_ld[4] = {nc1 + K4_PAD, nc1 + K4_PAD,
                                                           nc2 + K4_PAD, nc2 + K4_PAD};
    int n = 0;
    for (int i = 0; i < 4; ++i)
      for (int r0 = 0; r0 < seg_rows[i]; r0 += R.rows, ++n)
        if (tid == 0)
          desc[n] = {segs[i] + (size_t)r0 * seg_ld[i],
                     4 * min(R.rows, seg_rows[i] - r0) * seg_ld[i], 0};
    R.per_step = n;
  }
  R.total = R.per_step * K;
  if (tid == 0) {
    for (int i = 0; i < R.nst; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(full + i)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(smem_u32(empty + i)), "r"(K4_THREADS / 32) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < R.nst; ++c) ring_issue(R, c);
  int cc = 0;                          // the ring's next chunk to read

  // the states, transposed: lane s reads 16 bytes of stream s's row and
  // writes them to four rows; missing streams of a ragged last cluster stay
  // zero and write nothing
  auto load_state = [&](const float* src, float* dst, int n) {
    for (int i = tid; i < n * S / 4; i += K4_THREADS) {
      const int s = i % S, q = i / S;
      const float4 v = s < nact ? *reinterpret_cast<const float4*>(src + (size_t)(b0 + s) * n + 4 * q)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      dst[(4 * q) * S + s] = v.x;
      dst[(4 * q + 1) * S + s] = v.y;
      dst[(4 * q + 2) * S + s] = v.z;
      dst[(4 * q + 3) * S + s] = v.w;
    }
  };
  load_state(p.h1_in, h1, n1);
  load_state(p.h2_in, h2, n2);
  // a GRU's state after the step's mask: the candidate where the stream
  // moves, 16 bytes at a time
  auto apply_mask = [&](float* h, const float* hn, int n) {
    for (int i = tid; i < n * S / 4; i += K4_THREADS) {
      const int s = (4 * i) % S;
      float4 v = reinterpret_cast<float4*>(h)[i];
      const float4 c = reinterpret_cast<const float4*>(hn)[i];
      if (msk[s] > 0) v.x = c.x;
      if (msk[s + 1] > 0) v.y = c.y;
      if (msk[s + 2] > 0) v.z = c.z;
      if (msk[s + 3] > 0) v.w = c.w;
      reinterpret_cast<float4*>(h)[i] = v;
    }
  };
  // the step's inputs, transposed, for this rank's dense units
  auto load_inputs = [&](int k) {
    for (int i = tid; i < n_in * S; i += K4_THREADS) {
      const int c = i / S, s = i % S;
      xin[i] = s < nact ? p.inputs[((size_t)(b0 + s) * K + k) * n_in + c] : 0.f;
    }
  };
  // this rank's dense units of the input in xin, into its rows of dbuf
  auto dense1 = [&]() {
    for (int o = tid; o < ud * S; o += K4_THREADS) {
      const int j = o / S, s = o % S;
      float acc = 0.f;
      for (int c = 0; c < n_in; ++c) acc = fmaf(xin[c * S + s], d1_w[c * ud + j], acc);
      dbuf[(rank * ud + j) * S + s] = tanhf(acc + db[j]);
    }
  };
  // a GRU's update for this rank's u units from its products and its biases
  // b ([in | rec] x 3u): the new candidate into hn, the state after the
  // step's mask to `seq`
  auto gru_update = [&](const float* gi, const float* gr, const float* b, int n, int u,
                        const float* h, float* hn, float* seq, int k) {
    const int nc = 3 * u;
    for (int i = tid; i < u * S; i += K4_THREADS) {
      const int j = i / S, s = i % S, unit = rank * u + j;
      const float* gis = gi + j * S + s;
      const float* grs = gr + j * S + s;
      const float z = sigmoidf_((gis[0] + b[j]) + (grs[0] + b[nc + j]));
      const float r = sigmoidf_((gis[u * S] + b[u + j]) + (grs[u * S] + b[nc + u + j]));
      const float hc = tanhf((gis[2 * u * S] + b[2 * u + j]) +
                             r * (grs[2 * u * S] + b[nc + 2 * u + j]));
      const float h0 = h[unit * S + s];
      const float v = z * h0 + (1.f - z) * hc;
      hn[unit * S + s] = v;
      if (s < nact) seq[((size_t)(b0 + s) * K + k) * n + unit] = msk[s] > 0 ? v : h0;
    }
  };

  // the first step's dense layer, exchanged behind the set-up's barriers
  load_inputs(0);
  cluster.sync();       // every block runs before remote stores
  dense1();
  __syncthreads();
  send_rows<S>(cluster, dbuf, rank * ud, ud, rank, tid);
  cluster.sync();

  for (int k = 0; k < K; ++k) {
    // ---- GRU-1's two products and GRU-2's recurrent one; the step's masks
    // and the next step's inputs come in meanwhile
    if (tid < S) msk[tid] = tid < nact ? p.masks[(size_t)(b0 + tid) * K + k] : 0;
    if (k + 1 < K) load_inputs(k + 1);
    product<S>(R, cc, nd, nc1, dbuf, gi, tid);
    product<S>(R, cc, n1, nc1, h1, gr, tid);
    __syncthreads();
    gru_update(gi, gr, gb1, n1, u1, h1, h1n, p.h1_seq, k);
    __syncthreads();
    send_rows<S>(cluster, h1n, rank * u1, u1, rank, tid);
    cluster.sync();     // GRU-1's candidate whole in every block

    // ---- GRU-2's input product; the state of GRU-1 after the mask; the
    // next step's dense units
    apply_mask(h1, h1n, n1);
    product<S>(R, cc, n1, nc2, h1n, gi, tid);
    product<S>(R, cc, n2, nc2, h2, gr, tid);
    if (k + 1 < K) dense1();
    __syncthreads();
    gru_update(gi, gr, gb2, n2, u2, h2, h2n, p.h2_seq, k);
    __syncthreads();
    send_rows<S>(cluster, h2n, rank * u2, u2, rank, tid);
    if (k + 1 < K) send_rows<S>(cluster, dbuf, rank * ud, ud, rank, tid);
    cluster.sync();     // GRU-2's candidate and the next dense output whole

    // ---- GRU-2's state after the mask; this rank's outputs, from the
    // candidate: thread (stream, output), neighbouring threads on
    // neighbouring streams
    apply_mask(h2, h2n, n2);
    for (int i = tid; i < S * no; i += K4_THREADS) {
      const int s = i % S, jo = i / S;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < n2; ++c) acc = fmaf(h2n[c * S + s], ow[c * nom + jo], acc);
      if (s < nact)
        p.outs[((size_t)(b0 + s) * K + k) * n_out + rank + K4_CLUSTER * jo] = acc + ob[jo];
    }
    __syncthreads();
  }
}

typedef void (*ChainKernel)(ChainArgs);

ChainKernel chain_kernel_for(int streams) {
  switch (streams) {
    case 8: return chain_cluster_kernel<8>;
    case 16: return chain_cluster_kernel<16>;
    case 32: return chain_cluster_kernel<32>;
    default: return nullptr;
  }
}

// a block's shared memory (kernels/plc_chain.py::chain_smem_bytes computes
// the same)
size_t chain_smem(int s, int n_in, int nd, int n1, int n2, int n_out, int nst, int rows) {
  const int nc1 = 3 * n1 / K4_CLUSTER, nc2 = 3 * n2 / K4_CLUSTER, ud = nd / K4_CLUSTER;
  const int nom = (n_out + K4_CLUSTER - 1) / K4_CLUSTER, ncm = max(nc1, nc2);
  const size_t fl = (size_t)4 * s * (nd + 2 * n1 + 2 * n2 + 2 * ncm + n_in + 1) +
                    (size_t)4 * (n_in * ud + n2 * nom + 2 * nc1 + 2 * nc2 + ud + nom);
  return K4_HEAD + ((fl + 15) & ~(size_t)15) + (size_t)4 * nst * rows * (ncm + K4_PAD);
}

// chunks of `rows` rows a step
int chain_chunks(int nd, int n1, int n2, int rows) {
  return (nd + rows - 1) / rows + 2 * ((n1 + rows - 1) / rows) + (n2 + rows - 1) / rows;
}

bool widths_ok(int s, int nd, int n1, int n2) {
  return nd % K4_CLUSTER == 0 && n1 % K4_CLUSTER == 0 && n2 % K4_CLUSTER == 0 &&
         k_parts(3 * n1 / K4_CLUSTER, s) && k_parts(3 * n2 / K4_CLUSTER, s);
}

cudaLaunchConfig_t chain_config(int grid, size_t smem, cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K4_CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(K4_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The most clusters of K4 with `streams` streams a cluster and `smem` bytes
// a block that the card holds at once; a negative CUDA error code on
// failure.
extern "C" int lpcnet_plc_chain_max_clusters(int streams, int smem) {
  const ChainKernel k = chain_kernel_for(streams);
  if (!k) return -(int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = chain_config(K4_CLUSTER * 64, smem, 0, &attr);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, k, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

// K4. streams: S, 8, 16 or 32 a cluster of 8 blocks; nst: chunks in the
// weight ring, 2 to 4, of `rows` rows (a multiple of 4); smem: the block's
// shared memory as plc_chain.py::chain_smem_bytes counts it, refused unless
// it is chain_smem's; the weights packed by plc_chain.py::pack_chain_weights,
// the biases and the output layer as they are.
extern "C" int lpcnet_plc_chain(
    int streams, int nst, int rows, int smem, int batch, int k_steps, int n_in, int nd, int n1,
    int n2, int n_out,
    const void* d1_w, const void* d1_b, const void* g1_in, const void* g1_rec, const void* g1_b,
    const void* g2_in, const void* g2_rec, const void* g2_b, const void* out_w, const void* out_b,
    const void* inputs, const void* masks, const void* h1_in, const void* h2_in,
    void* h1_seq, void* h2_seq, void* outs, void* stream) {
  const ChainKernel k = chain_kernel_for(streams);
  if (!k || batch <= 0 || k_steps <= 0 || n_in <= 0 || n_out <= 0 || nst < 2 ||
      nst > K4_BARS / 16 || rows < 4 || rows % 4 || !widths_ok(streams, nd, n1, n2) ||
      chain_chunks(nd, n1, n2, rows) > K4_CHUNKS ||
      (size_t)smem != chain_smem(streams, n_in, nd, n1, n2, n_out, nst, rows))
    return (int)cudaErrorInvalidValue;
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
  a.nst = nst;
  a.rows = rows;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int clusters = (batch + streams - 1) / streams;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = chain_config(clusters * K4_CLUSTER, smem, (cudaStream_t)stream, &attr);
  e = cudaLaunchKernelEx(&cfg, k, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
