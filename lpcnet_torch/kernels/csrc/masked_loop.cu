// K2: the LPCNet sample loop under per-stream, per-sample control masks, one
// frame per launch, redesigned for Hopper.
//
// Replaces the TPU kernel lpcnet_tpu/kernels/sample_loop.py::_ar_kernel run
// with masked=True (synthesize_frame_masked_pallas, with or without the
// sampler). Each stream runs n_samples dependent steps: LPC prediction,
// u-law codes, the three-row embedding gather plus the reset-after GRU-A,
// GRU-B, the dual-FC node logits, the 8-bit tree descent on KISS99
// threshold bytes, de-emphasis, clip and round. A mode word per stream and
// sample (bit 0 advance, bit 1 teacher-force) masks it: with advance off the
// stream's whole state, its KISS99 words included, stays as it is and the
// sample is 0; with teacher-force on, the target (de-emphasised domain) sets
// the excitation and the sample. With sampled == 0 the dual-FC and the tree
// are skipped; every advanced step must then be teacher-forced.
//
// What bounds it on an H100: the chain of dependent steps. The operations
// (0.46 M multiply-adds a stream and step) and the bytes are a few hundredths
// of a millisecond a frame. The first design (a block of 4 streams sweeping
// GRU-A's whole recurrent matrix, 0.88 MB in bf16, from L2 every step on the
// CUDA cores; 32 of 132 SMs busy at 128 streams) took ~57 us a step; this
// one ~8.6 us at 128 streams (bf16), most of it the serial per-stream work
// (tree, u-law codes), the embedding gathers from L2 and two barriers.
//
// What this design does about it:
// * A cluster of C blocks owns S streams for the whole frame. Block rank r
//   owns U units of GRU-A (C = 8, U = 48 at Na = 384) and their 3U gate
//   columns [z | r | h]; U is a multiple of 16, and the C U - Na units past
//   Na (any Na runs) are padding whose weights are zero and whose state
//   stays 0. GRU-B's width is padded to a multiple of 16 the same way. The
//   block's slice of the recurrent matrix is copied into shared memory once
//   per launch (bf16 110.6 KB, q8 55.3 KB at Na = 384) and read from there
//   for all n steps, and so are GRU-B's packed weights (38.4 KB in bf16).
//   Where they do not fit beside the rest (GRU-B's at 32 streams; GRU-A's in
//   bf16 at Na = 640, 307 KB a slice) the block reads them from L2 in place.
// * The f32 form runs on the CUDA cores with K1's arithmetic (the tensor
//   cores would change its numerics) on clusters of C = 16 blocks, the
//   H100's non-portable cluster size (the card holds 7 such clusters):
//   rank r owns U = 24 units at Na = 384 (a multiple of 4; no MMA tile),
//   and its f32 slice, 110.6 KB as the bf16 slice at C = 8, stays in shared
//   memory (at Na = 640, U = 40, 307 KB, it is read from L2). The slice is
//   packed [k quad][3U | 1][4] (kernels/masked_loop.py::pack_gru_a; an odd
//   row of 16-byte words keeps the lanes' loads conflict-free). A warp
//   takes (stream tile, 4 local columns): lane l sums the k quads l,
//   l + 32, ... into an 8 x 4 register tile, each loaded word used 4 or 8
//   times (a 16-byte shared-memory load costs four cycles of the SM's
//   port, so a column a thread, as in the first design, left the product
//   bound by the loads at four times the FMAs' time; an 8 x 8 tile spills
//   beside the rest of the kernel's registers), then the lanes meet in a
//   fixed order, a reduce-scatter of five shuffles. In K1 (free-running), where
//   each step's codes barrier sees every block's product done before any
//   block sends its new slice, one operand buffer serves (a second would
//   cap S at 32); GRU-B's input product, whose weights (73.7 KB) every
//   block would otherwise read from L2 every step, is summed per rank over
//   its own units right after the gate phase and sent with the slice to
//   the owner of each stream's tail, who adds the ranks' parts in order.
//   The first f32 design (sample_loop.cu's ar_kernel: a block of 4 streams
//   sweeping the whole 1.77 MB matrix from L2 every step, 55 us a step at
//   4 and at 1024 streams) keeps the batches above two waves of 16-block
//   clusters (kernels/sample_loop.py::f32_route): the card holds 7 such
//   clusters, and a wave costs about what that kernel takes for 1024
//   streams.
// * S is 8, 16 or 32, the smallest that fits the card in one wave of
//   clusters (kernels/masked_loop.py::masked_launch_config, from the card's
//   cluster occupancy). An H100 holds 15 clusters of 8 such blocks, so 128
//   streams run as 8 clusters of 16, 64 (a PLC frame) as 8 of 8, and 256 as
//   8 of 32. A ragged last cluster masks its missing streams.
// * GRU-A's product runs on the tensor cores as out^T = W^T h^T: the weight
//   slice is the A operand (16 gate columns a tile), the streams are N (8 a
//   tile). bf16: mma.sync m16n8k16, f32 sums; q8: m16n8k32 s8 x s8 -> s32,
//   exact, so q8 stays bit-equal to its plain version. The wrapper packs the
//   weights in the A fragments' register order, so a lane's fragment is one
//   16-byte shared-memory load. Each warp takes whole (column tile, stream
//   tile) tasks.
// * The gate phase: thread (stream, unit) gathers its three embedding rows
//   for its three columns (from L2), adds the conditioning and the bias, and
//   forms the new h_a itself. The block's slice of the new operand copy
//   (bf16, int8 or f32) then goes into every other block's shared memory
//   through distributed shared memory, 16 bytes a store, double-buffered,
//   behind one cluster barrier a step. After it every block holds the whole
//   new h_a.
// * GRU-B, the dual-FC logits, the tree descent with KISS99, the LPC
//   prediction and the PCM then run redundantly in every block on identical
//   inputs with identical RNG words, so no second cluster barrier is needed;
//   only rank 0 writes the PCM and the carried state (each rank writes its
//   own h_a units). GRU-B's two products ([S, Na] x [Na, 3Nb] and
//   [S, Nb] x [Nb, 3Nb]) take the tensor cores too (its weights packed the
//   same way, 38.4 KB in bf16). Of the dual-FC's 256 node logits a stream
//   needs only the 8 its descent visits: the block computes the 15 nodes of
//   levels 0-3, warp 0 descends them, then the 15 under the node reached
//   (30 of 256, two rounds over all threads). A stream that is
//   teacher-forced or frozen at a step computes none; the RNG advances as
//   before.
// * Warp 0 owns the streams' scalar state in registers (signal history, LPC,
//   de-emphasis, prediction, KISS99 words, the next step's mode and target,
//   loaded a step ahead) and runs the tree's last four levels and the next
//   step's u-law codes while the warps on the other three schedulers run
//   the next step's GRU-A product.
// * With every mode word 1 (advance, no teacher-forcing) and the sampler on,
//   the kernel computes the free-running sample loop, K1's function.
//
// K1, the free-running loop (replaces _ar_kernel run with masked=False,
// sample_loop.py:461, whose first port was ar_kernel<FORM> in
// sample_loop.cu, which f32 keeps above two waves): the kind KIND_FREE. It reads no preload or mode
// words, has no frozen or teacher-forced branch and always samples. Of the
// two ways to serve 1024 streams in fewer waves, it splits the tail rather
// than give warp 0's lanes two streams each: the per-stream tail (GRU-B, the
// 30 dual-FC nodes, the tree, LPC and PCM) ran redundantly in all C blocks,
// and it grows with S, so two streams a lane would double every block's
// tail (and at S = 64 the h_a operand buffers, 100 KB, push GRU-A's slice
// out of shared memory). Here rank r runs the tail of streams
// [r SO, r SO + SO), SO = S / C (4 of 32): its GRU-B products are one tile
// of 8 streams, its node logits a fifth of a round. The new excitation
// codes (sig_u, pred_u, exc) go from each stream's owner to every block (one
// 16-byte DSMEM store a stream and block), since the next step's embedding
// gather in every block needs them: one more cluster barrier a step, where
// the masked form has a block barrier. Warp 0 no longer caps S at 32: S = 40
// also fits a block (bf16: GRU-A resident, GRU-B from L2, 224,176 bytes),
// and 1024 streams take 26 clusters, two waves of 15 in place of three. A
// single wave (S = 72) does not fit: two h_a operand buffers of 72 streams
// (113 KB in bf16) and the 110.6 KB slice exceed a block.
//
// K6, the merged-product loop (replaces
// sample_loop.py::_sample_kernel_merged; its first port, ar_kernel<FORM,
// true> in sample_loop.cu, read the merged matrices' zero blocks from L2
// every step and is gone): the same function as K1, since a zero block adds
// nothing to a float32 sum. It is this free-running form on the merged
// matrices' non-zero blocks, packed as K1's (kernels/sample_loop.py::
// merged_packs, which checks the padding blocks are zero), with the
// conditioning's merged 4N layout converted once a launch into K1's.
//
// K3, the teacher-forced run (replaces sample_loop.py::_tf_kernel,
// teacher_force_blocks_pallas; its first port, tf_kernel in a first design,
// swept GRU-A's matrix from L2 every step with three block barriers, ~45 us
// a dependent step, and is gone): the kind KIND_TF. Every input is known
// before the launch: the u-law codes of every step (three bytes a stream
// and step, from tf_precompute in PyTorch), the conditioning of each of
// n_blocks blocks, and a step count per stream and block. Stream s advances
// at step t of block k iff t < counts[s, k]; the cluster runs block k up to
// the largest count among its own streams (every rank reads the same
// counts, so all take the same number of cluster barriers), and a cluster
// with nothing to run copies its state out and stops. What it keeps of K2:
// the clusters, GRU-A's resident slice, the product on the tensor cores and
// the DSMEM exchange behind one cluster barrier a step. What it changes:
// * no LPC, u-law, dual-FC, tree or PCM; warp 0 has no per-stream chain;
// * the gate inputs leave the chain: a thread reads its streams' code bytes
//   two steps ahead and issues the three embedding rows' gathers and the
//   conditioning's loads one step ahead, between the cluster barrier's
//   arrive and its wait, and adds them (in K2's order) in the next gate
//   phase;
// * nothing in the loop reads h_b, so GRU-B leaves the chain too: rank r
//   owns the tail streams [r SO, r SO + SO) as in the free-running form,
//   and warps 0, 4 and 8 (the three that take no GRU-A tile) run its two
//   products for step t-1 beside step t's GRU-A product and its update
//   inside the cluster barrier's wait;
// * the KISS99 words, which nothing in the loop reads, advance after it by
//   twice the stream's total count, in the tail's owner only.
//
// The factored q8 embedding (FACT, instantiations of their own, so that
// the composed forms keep their code and registers; replaces the
// LPCNET_EMB=factored operand form of _ar_kernel and _tf_kernel,
// sample_loop.py:265 and :775, whose _gru_ab, :291-303, gathers three rows
// of the shared 128-wide int8 embedding and multiplies them by GRU-A's
// input kernel with the embedding's scales folded in): in every kind, a
// step's gate input is cond + (g . W_in) * t, g [S, 384] the three gathered
// int8 rows of a stream, W_in the rank's [384, 3U] int8 slice of the input
// kernel (55.3 KB at Na = 384, packed by masked_loop.py::pack_embf,
// resident where it fits), t its column scales. The product is m16n8k32 s8
// on the tensor cores into int32, exact in any order. A warp task is (unit
// tile, stream tiles), the three gates' column tiles of 16 units, so that
// each B fragment of g serves three MMAs and a lane ends holding all three
// gates of its (stream, unit) pairs. Where these tasks fill the block's
// warps (S >= 32) the product runs fused with the gate phase (fact_gate):
// the lane then updates those pairs, with no array of sums and no barrier
// between. Below (3 or 6 such tasks at Na = 384), where so few warps would
// carry the whole gate phase, the product takes GRU-A's tasks of one
// gate's 16 columns and writes its sums to eacc for the gate phase's
// per-pair threads (fact_array). The product is bound by shared
// memory's port (a 16-byte A fragment a lane a load), not the tensor
// cores. The 32 KB table is read from L2 in 16-byte words, where the
// chain of dependent phases waits on it least:
// * K1 and K2 learn a step's codes only at its start, from the previous
//   step's tail, but in K1 warp 0 has them long before GRU-A's product
//   ends (1.7 k against 5.6 k cycles at S = 40). So warps 0, 4 and 8,
//   which take no GRU-A tile, load the rows of the tail's streams as soon
//   as warp 0 has their codes and store them into every block's g; the
//   codes barrier orders them. K2 does the same into its own g at S >= 32;
//   at S <= 16, where its warp 0 is the step's laggard already, every
//   thread gathers the rows after the codes barrier. At S = 40 every
//   weight set stays resident (223,280 bytes a block).
// * K3 knows its codes before the launch: the nine product warps load step
//   j+1's rows in the cluster barrier's window of step j, while warps 0, 4
//   and 8 run GRU-B's update, and at S <= 16 run their product there too,
//   into eacc, behind a barrier of the nine; the next block barrier orders
//   both.

#include <cooperative_groups.h>

#include "sample_common.cuh"

namespace cg = cooperative_groups;

namespace {

#define K2_THREADS 384
#define K2_WARPS (K2_THREADS / 32)

typedef __nv_bfloat16 bf16;

// the kernel's kinds: K2 (masks), K1 (free-running), K3 (teacher-forced run)
enum { KIND_MASKED = 0, KIND_FREE = 1, KIND_TF = 2 };


struct K2Args {
  int batch, na, nb, n_samples, sampled, cluster;
  int res_a, res_b;         // GRU-A's slice, GRU-B's weights in shared memory
  int res_f;                // the factored q8 embedding: its input kernel's slice in shared memory
  int n_blocks, blk;        // K3: conditioning blocks, steps a block
  const int* counts;        // K3: [B, n_blocks] steps to run
  const uint8_t* codes;     // K3: [B, n_blocks * blk, 3] sig_u, pred_u, exc
  const void* emb;          // [768, 3Na] f32 / bf16 / int8; factored: the shared embedding [256, 128] int8
  const float* emb_scale;   // [3Na] (q8; factored: the input kernel's column scales)
  const void* a_w;          // packed slices: bf16 / q8 [C][3U/16][ceil(Na/KS)][32][16 bytes]; f32 [C][ceil(Na/4)][3U][4]
  const float* a_diag;      // [3Na] (q8)
  const float* a_bias1;     // [3Na]
  const void* b_w;          // bf16 / q8: packed [3Nbp/16][ceil(Na/KS) + ceil(Nb/KS)][32][16 bytes]
  const float* b_in;        // f32 form: [Na, 3Nb]
  const float* b_rec;       // f32 form: [Nb, 3Nb]
  const float* b_bias1;     // [3Nb]
  const void* f_w;          // factored: the input kernel's packed slices [C][3U/16][FACT_K/32][32][16 bytes]
  const float* dual_w;      // [Nb, 512]
  const float* dual_bias;   // [512]
  const float* dual_factor; // [512]
  const float* logit_table; // [256]
  const float* cond_a;      // [B, 3Na] (K3: [B, n_blocks, 3Na])
  const float* cond_b;      // [B, 3Nb] (K3: [B, n_blocks, 3Nb])
  const float* lpc;         // [B, 16]
  const float* ha_in; const float* hb_in; const float* sig_in;
  const int* exc_in; const float* de_in; const long long* rng_in;
  float* ha_out; float* hb_out; float* sig_out;
  int* exc_out; float* de_out; long long* rng_out;
  float* pcm;               // [B, n_samples]
  const float* preload;     // [B, n_samples] target, de-emphasised domain
  const int* mode;          // [B, n_samples] advance | teacher_force << 1
};

// The factored q8 embedding: a stream's three gathered rows of the shared
// 128-wide embedding, [sig_u | pred_u | exc], the depth of the input
// kernel's product; FACT_LD the row of their operand in shared memory
// (padded as the q8 h_a operand, conflict-free fragment loads).
constexpr int FACT_E = 128, FACT_K = 3 * FACT_E, FACT_LD = FACT_K + 16;

// Per-form constants: KS the k depth of one MMA, XPAD the padding of the
// operand rows in shared memory (conflict-free fragment loads), ESZ the
// operand's bytes.
__host__ __device__ constexpr int form_ks(int form) { return form == FORM_Q8 ? 32 : 16; }
__host__ __device__ constexpr int form_esz(int form) {
  return form == FORM_F32 ? 4 : (form == FORM_BF16 ? 2 : 1);
}
__host__ __device__ constexpr int form_xpad(int form) {
  return form == FORM_F32 ? 4 : (form == FORM_BF16 ? 8 : 16);
}
template <int FORM> struct K2Form {
  static constexpr int KS = form_ks(FORM);
  static constexpr int ESZ = form_esz(FORM);
  static constexpr bool MMA = FORM != FORM_F32;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }
__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The shared-memory layout of one block, in bytes; the Python side
// (masked_loop.py::masked_smem_bytes) computes the same total. U, the units
// of a rank: 16 ceil(Na / (16 C)) (f32: 4 ceil(Na / (4 C))); Nbp =
// 16 ceil(Nb / 16). The free-running form keeps its tail arrays for one
// tile of 8 streams (TR = 8, else S), its codes four words a stream (one
// 16-byte store a block) and, in bf16 and q8, 8 rows more in each h_a
// operand buffer (the GRU-B tile of the last rank reads past S). In f32 it
// keeps one operand buffer (its codes barrier orders every block's product
// before any block's new slice), the ranks' parts of GRU-B's input
// product for its tail streams, gbin [C][SO][3Nb rounded up to 4], and the
// rank's U rows of GRU-B's input matrix, brow [U][3Nb rounded up to 4].
// The teacher-forced form (K3) splits the tail as the free-running one
// does, has no node logits, threshold table or codes, and keeps the counts
// of its S streams for each of n_blocks blocks and each block's largest.
// The factored q8 embedding adds its rank's slice of the input kernel
// (where res_f), the gathered rows g [S][FACT_LD] and, at S <= 16, where
// the gate phase reads g's product from shared memory, its sums [S][ldz]
// int32.
struct K2Layout {
  int u, nbp, ksa, ksbr, ldx, ldb, ldz, ldg, hrows, hbufs, kq, ncolp, nb3p;
  size_t wa, wb, hop, hbop, zacc, gacc, haown, hbf, logits, code, table, wf, gop, eacc, gbin,
      brow, flags, total;
};

__host__ __device__ inline K2Layout k2_layout(int form, int na, int nb, int cluster, int s,
                                              bool res_a, bool res_b, int kind,
                                              int n_blocks, bool fact, bool res_f) {
  const int ks = form_ks(form), esz = form_esz(form);
  const bool mma = form != FORM_F32;
  const bool free_ = kind == KIND_FREE, tf = kind == KIND_TF;
  const int tr = free_ || tf ? 8 : s;
  K2Layout L;
  L.u = round_up((na + cluster - 1) / cluster, mma ? 16 : 4);
  L.nbp = round_up(nb, 16);
  L.ksa = (na + ks - 1) / ks;
  L.ksbr = (nb + ks - 1) / ks;
  L.kq = (na + 3) / 4;
  L.ncolp = (3 * L.u) | 1;         // f32 pack's words a k quad: odd, conflict-free
  L.nb3p = round_up(3 * nb, 4);
  const bool k1_f32 = free_ && !mma;
  L.hbufs = k1_f32 ? 1 : 2;
  L.ldx = round_up(cluster * L.u, 128 / esz) + form_xpad(form);
  L.ldb = mma ? L.ksbr * ks + form_xpad(form) : nb + form_xpad(form);
  L.ldz = 3 * L.u + 4;
  L.ldg = 3 * L.nbp + 4;
  L.hrows = (free_ || tf) && mma ? s + 8 : s;
  const size_t wslice = !res_a ? 0
                        : mma ? (size_t)3 * L.u * L.ksa * ks * esz : (size_t)L.kq * L.ncolp * 16;
  const size_t wbytes = mma && res_b ? (size_t)3 * L.nbp * (L.ksa + L.ksbr) * ks * esz : 0;
  size_t off = 0;
  L.wa = off; off += align16(wslice);
  L.wb = off; off += align16(wbytes);
  L.hop = off; off += align16((size_t)L.hbufs * L.hrows * L.ldx * esz);
  L.hbop = off; off += align16((size_t)tr * L.ldb * esz);
  L.zacc = off; off += align16((size_t)s * L.ldz * 4);
  L.gacc = off; off += align16((size_t)2 * tr * L.ldg * 4);
  L.haown = off; off += align16((size_t)s * L.u * 4);
  L.hbf = off; off += align16((size_t)tr * nb * 4);
  L.logits = off; off += tf ? 0 : align16((size_t)tr * 32 * 4);
  L.code = off;
  off += align16((size_t)(tf ? n_blocks * (s + 1) : (free_ ? 4 : 3) * s + tr) * 4);
  L.table = off; off += tf ? 0 : 256 * 4;
  L.wf = off; off += fact && res_f ? align16((size_t)3 * L.u * FACT_K) : 0;
  L.gop = off; off += fact ? align16((size_t)s * FACT_LD) : 0;
  L.eacc = off; off += fact && s <= 16 ? align16((size_t)s * L.ldz * 4) : 0;
  L.gbin = off;
  off += k1_f32 ? align16((size_t)cluster * ((s + cluster - 1) / cluster) * L.nb3p * 4) : 0;
  L.brow = off; off += k1_f32 ? align16((size_t)L.u * L.nb3p * 4) : 0;
  L.flags = off; off += 16;
  L.total = off;
  return L;
}

// the GRU operand copy in the operand's own type
template <int FORM> struct OpT;
template <> struct OpT<FORM_F32> {
  typedef float T;
  static __device__ __forceinline__ float of(float h) { return h; }
};
template <> struct OpT<FORM_BF16> {
  typedef bf16 T;
  static __device__ __forceinline__ bf16 of(float h) { return __float2bfloat16_rn(h); }
};
template <> struct OpT<FORM_Q8> {
  typedef int8_t T;
  static __device__ __forceinline__ int8_t of(float h) { return (int8_t)operand<FORM_Q8>(h); }
};

// a weight through the read-only path, widened to its sum's type
__device__ __forceinline__ float ldw(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float ldw(const bf16* p, size_t i) { return __bfloat162float(__ldg(p + i)); }
__device__ __forceinline__ int ldw(const int8_t* p, size_t i) { return (int)__ldg(p + i); }

// the logit of tree node nd from h_b (both channels: dual-FC columns nd and
// 256 + nd), in K1's arithmetic
__device__ __forceinline__ float node_logit(const K2Args& p, const float* h, int nb, int nd) {
  float p0 = 0.f, p1 = 0.f;
#pragma unroll 16
  for (int k = 0; k < nb; ++k) {           // all the weight reads in flight at once
    p0 += h[k] * __ldg(p.dual_w + k * 512 + nd);
    p1 += h[k] * __ldg(p.dual_w + k * 512 + 256 + nd);
  }
  const float t0 = __fmul_rn(__ldg(p.dual_factor + nd), tanhf(__fadd_rn(p0, __ldg(p.dual_bias + nd))));
  const float t1 = __fmul_rn(__ldg(p.dual_factor + 256 + nd),
                             tanhf(__fadd_rn(p1, __ldg(p.dual_bias + 256 + nd))));
  return __fadd_rn(t0, t1);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma16832(int (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// One (column tile, stream tile) of out[n][m] = sum_k x[n][k] W^T[m][k] over
// `ksteps` k steps on the tensor cores, by one warp, k in order. wf: the
// tile's packed A fragments, [ksteps][32] 16-byte words; x: the tile's first
// operand row, `ldx` elements a row; out: the tile's first output, `ldo` a
// row.
template <int FORM>
__device__ __forceinline__ void tile_mma(const uint4* wf, int ksteps,
                                         const typename OpT<FORM>::T* x, int ldx,
                                         typename FormT<FORM>::Acc* out, int ldo, int lane) {
  typedef typename FormT<FORM>::Acc Acc;
  constexpr int KS = K2Form<FORM>::KS;
  constexpr int E = 4 / K2Form<FORM>::ESZ;      // operand elements a 32-bit word
  const int g = lane >> 2, t = lane & 3;
  const typename OpT<FORM>::T* xr = x + g * ldx + t * E;
  Acc acc[4] = {0, 0, 0, 0};
#pragma unroll 4
  for (int ks = 0; ks < ksteps; ++ks) {
    const uint4 a = wf[ks * 32 + lane];
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr + ks * KS);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + ks * KS + KS / 2);
    if constexpr (FORM == FORM_Q8) {
      mma16832(acc, a, b0, b1);       // int32 sums: exact in any order
    } else {
      // each k step's 16 products summed by the tensor core from zero, the
      // running sum kept in IEEE float32 adds: the tensor core's own
      // accumulation does not round to nearest, and an error of a few
      // float32 units in h_a flips the bf16 operand of later steps
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma16816(d, a, b0, b1);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += d[i];
    }
  }
  // D fragment: c0, c1 at (column g, streams 2t, 2t+1); c2, c3 at column g+8
  out[(2 * t) * ldo + g] = acc[0];
  out[(2 * t + 1) * ldo + g] = acc[1];
  out[(2 * t) * ldo + g + 8] = acc[2];
  out[(2 * t + 1) * ldo + g + 8] = acc[3];
}

// One warp's task of the f32 GRU-A product: the sums of 8 streams
// (operand rows x, x + ldx, ...) for local columns [4 g, 4 g + 4) of the
// rank's packed slice w [kq][ncolp] (16-byte words: four k of a column; in
// shared memory or L2). Lane l takes the k quads l, l + 32, ...: an 8 x 4
// tile of FMA chains in registers, each operand word read once a quad; the
// 32 lanes' tiles then meet in a fixed-order reduce-scatter over five
// shuffle levels, after which lane l holds the sum of tile entry l (stream
// l / 4, column 4 g + l % 4) and stores it.
template <bool SHARED>
__device__ __forceinline__ void f32_tile(const float4* w, int ncolp, int ncol, int kq, int g,
                                         const float* x, int ldx, float* out, int ldo,
                                         int lane) {
  float a[32];                                   // a[4 s + c]
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = 0.f;
  const int c0 = 4 * g;
  for (int q = lane; q < kq; q += 32) {
    float4 wv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + c < ncol) {
        const float4* wp = w + (size_t)q * ncolp + c0 + c;
        wv[c] = SHARED ? *wp : __ldg(wp);
      }
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float4 xv = *reinterpret_cast<const float4*>(x + s * ldx + 4 * q);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float& acc = a[4 * s + c];
        acc = fmaf(xv.x, wv[c].x, acc);
        acc = fmaf(xv.y, wv[c].y, acc);
        acc = fmaf(xv.z, wv[c].z, acc);
        acc = fmaf(xv.w, wv[c].w, acc);
      }
    }
  }
  // at mask m, a lane keeps the half of its n sums that its bit m selects
  // and adds its partner's copy of that half
#define F32_RS(M, H)                                                        \
  {                                                                         \
    const bool up = (lane & (M)) != 0;                                      \
    _Pragma("unroll") for (int i = 0; i < (H); ++i) {                       \
      const float keep = up ? a[(H) + i] : a[i], send = up ? a[i] : a[(H) + i]; \
      a[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, (M)));     \
    }                                                                       \
  }
  F32_RS(16, 16) F32_RS(8, 8) F32_RS(4, 4) F32_RS(2, 2) F32_RS(1, 1)
#undef F32_RS
  const int c = c0 + (lane & 3);
  if (c < ncol) out[(lane >> 2) * ldo + c] = a[0];
}

// K3's gate inputs of one (stream, unit) pair as loaded, before any sum: the
// three embedding rows' values of its three gate columns in the weights' own
// type and the block's conditioning. Held in registers from the loads'
// issue, a step ahead, to the gate phase that adds them.
__device__ __forceinline__ float wf(float x) { return x; }
__device__ __forceinline__ float wf(bf16 x) { return __bfloat162float(x); }

template <int FORM> struct GateRaw {
  typename FormT<FORM>::W e[3][3];   // [embedding row][gate]
  float ca[3];
};

template <int FORM, int NT, int KIND, bool FACT>
__global__ void __launch_bounds__(K2_THREADS, 1) masked_loop_kernel(K2Args p) {
  typedef typename FormT<FORM>::W W;
  typedef typename FormT<FORM>::Acc Acc;
  typedef typename OpT<FORM>::T OT;
  typedef K2Form<FORM> F;
  constexpr bool FREE = KIND == KIND_FREE, TF = KIND == KIND_TF;
  constexpr bool SPLIT = FREE || TF;      // the tail split over the ranks
  constexpr int S = 8 * NT;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster;
  const int rank = (int)cluster.block_rank();
  const int na = p.na, nb = p.nb, na3 = 3 * na, nb3 = 3 * nb;
  // the factored q8 embedding: instantiations of its own, so that the
  // composed forms' code and registers are those of a kernel without it
  static_assert(!FACT || FORM == FORM_Q8, "the factored embedding is a q8 form");
  constexpr bool fact = FACT;
  const K2Layout L = k2_layout(FORM, na, nb, C, S, p.res_a, p.res_b, KIND, p.n_blocks, FACT,
                               p.res_f);
  const int U = L.u, u0 = rank * U, n = p.n_samples, nbp = L.nbp;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = (blockIdx.x / C) * S;
  const int nact = min(S, p.batch - b0);
  // the streams whose tail (GRU-B to PCM) this block runs: all S in the
  // masked form; in the free-running and teacher-forced forms rank r owns
  // [r SO, r SO + SO)
  const int SO = SPLIT ? (S + C - 1) / C : S;
  const int s0 = SPLIT ? rank * SO : 0;
  const int so = SPLIT ? max(0, min(SO, S - s0)) : S;  // this rank's tail streams
  const int TR = SPLIT ? 8 : S;                        // tail rows in shared memory

  extern __shared__ __align__(16) unsigned char smem[];
  // the packed weights: this rank's GRU-A slice and GRU-B's, in shared
  // memory (wa_s, wb_s) where they fit, else read from L2 in place (wa_g,
  // wb_g). The products take one or the other in separate calls, so that
  // the resident case keeps its shared-memory loads.
  const size_t na_words = F::MMA ? (size_t)3 * U * L.ksa * F::KS * F::ESZ / 16
                                 : (size_t)L.kq * L.ncolp;
  const size_t nb_words = (size_t)3 * nbp * (L.ksa + L.ksbr) * F::KS * F::ESZ / 16;
  const uint4* wa_g = reinterpret_cast<const uint4*>(p.a_w) + (size_t)rank * na_words;
  const uint4* wb_g = reinterpret_cast<const uint4*>(p.b_w);
  uint4* wa_s = reinterpret_cast<uint4*>(smem + L.wa);
  uint4* wb_s = reinterpret_cast<uint4*>(smem + L.wb);
  OT* hop = reinterpret_cast<OT*>(smem + L.hop);          // [2][hrows][ldx] operand of h_a
  OT* hbop = reinterpret_cast<OT*>(smem + L.hbop);        // [TR][ldb] operand of h_b
  Acc* zacc = reinterpret_cast<Acc*>(smem + L.zacc);      // [S][ldz] GRU-A products
  Acc* gin = reinterpret_cast<Acc*>(smem + L.gacc);       // [TR][ldg] GRU-B input part
  Acc* grec = gin + TR * L.ldg;                           // [TR][ldg] GRU-B recurrent part
  float* haown = reinterpret_cast<float*>(smem + L.haown); // [S][U] this rank's h_a
  float* hbf = reinterpret_cast<float*>(smem + L.hbf);     // [TR][nb] h_b
  float* logits = reinterpret_cast<float*>(smem + L.logits); // [TR][32] visited nodes
  constexpr int CW = FREE ? 4 : 3;                         // code words a stream
  int* code = reinterpret_cast<int*>(smem + L.code);       // [S][CW] sig_u, pred_u, exc
  int* top = code + CW * S;                                // [TR] the tree's first 4 bits
  // K3: [n_blocks][S] the streams' counts, then [n_blocks] each block's largest
  int* cnt = reinterpret_cast<int*>(smem + L.code);
  unsigned* flags = reinterpret_cast<unsigned*>(smem + L.flags); // live, sampler needed
  float* table = reinterpret_cast<float*>(smem + L.table); // [256] threshold logits
  const int hstride = L.hrows * L.ldx;                     // one operand buffer
  const int hnext = L.hbufs > 1 ? hstride : 0;             // the other one, if any
  float* gbin = reinterpret_cast<float*>(smem + L.gbin);   // f32 K1: [C][SO][nb3p]
  float* brow = reinterpret_cast<float*>(smem + L.brow);   // f32 K1: [U][nb3p]
  // the factored embedding: this rank's input-kernel slice (shared memory
  // or L2), the gathered rows g and their products
  constexpr int KSF = FACT_K / 32;
  const size_t nf_words = (size_t)3 * U * FACT_K / 16;
  const uint4* wf_g = reinterpret_cast<const uint4*>(p.f_w) + (size_t)rank * nf_words;
  uint4* wf_s = reinterpret_cast<uint4*>(smem + L.wf);
  int8_t* gop = reinterpret_cast<int8_t*>(smem + L.gop);  // [S][FACT_LD]
  int* eacc = reinterpret_cast<int*>(smem + L.eacc);       // [S][ldz] g's products (S <= 16)

  // K3: the steps the cluster runs (0 when no stream of it has any)
  const int nbk = p.n_blocks;
  int total = 1;
  if constexpr (TF) {
    for (int i = tid; i < nbk * S; i += K2_THREADS) {
      const int k = i / S, s = i % S;
      const int c = s < nact ? p.counts[(size_t)(b0 + s) * nbk + k] : 0;
      cnt[i] = min(max(c, 0), p.blk);
    }
    __syncthreads();
    for (int k = tid; k < nbk; k += K2_THREADS) {
      int m = 0;
      for (int s = 0; s < S; ++s) m = max(m, cnt[k * S + s]);
      cnt[nbk * S + k] = m;
    }
    __syncthreads();
    total = 0;
    for (int k = 0; k < nbk; ++k) total += cnt[nbk * S + k];
  }

  // ---- set-up: weights into shared memory, the carried state
  if (p.res_a && total > 0)
    for (size_t i = tid; i < na_words; i += K2_THREADS) wa_s[i] = wa_g[i];
  if (F::MMA && p.res_b && total > 0)
    for (size_t i = tid; i < nb_words; i += K2_THREADS) wb_s[i] = wb_g[i];
  if (fact && p.res_f && total > 0)
    for (size_t i = tid; i < nf_words; i += K2_THREADS) wf_s[i] = wf_g[i];
  if (FREE && !F::MMA)
    for (int i = tid; i < U * L.nb3p; i += K2_THREADS) {
      const int j = i / L.nb3p, c = i % L.nb3p;
      brow[i] = u0 + j < na && c < nb3 ? __ldg(p.b_in + (size_t)(u0 + j) * nb3 + c) : 0.f;
    }
  for (int i = tid; i < hstride; i += K2_THREADS) {
    const int s = i / L.ldx, k = i % L.ldx;
    const float h = (s < nact && k < na) ? p.ha_in[(size_t)(b0 + s) * na + k] : 0.f;
    hop[i] = OpT<FORM>::of(h);
    if (L.hbufs > 1) hop[hstride + i] = OpT<FORM>::of(0.f);
  }
  for (int i = tid; i < S * U; i += K2_THREADS) {
    const int s = i / U, u = u0 + i % U;
    haown[i] = s < nact && u < na ? p.ha_in[(size_t)(b0 + s) * na + u] : 0.f;
  }
  for (int i = tid; i < TR * L.ldb; i += K2_THREADS) {
    const int sl = i / L.ldb, k = i % L.ldb, s = s0 + sl;
    const float h = (sl < so && s < nact && k < nb) ? p.hb_in[(size_t)(b0 + s) * nb + k] : 0.f;
    hbop[i] = OpT<FORM>::of(h);
    if (k < nb) hbf[sl * nb + k] = h;
  }

  // GRU-A's product of one step on the operand `cur`, into zacc; `pt` is
  // this thread's index among the `npt` threads that take it
  auto gru_a_product = [&](const OT* cur, int pt, int npt) {
    if constexpr (F::MMA) {
      const int mta = 3 * U / 16;
      for (int task = pt >> 5; task < mta * NT; task += npt >> 5) {
        const int mt = task % mta, nt = task / mta;
        const size_t w0 = (size_t)mt * L.ksa * 32;
        if (p.res_a)
          tile_mma<FORM>(wa_s + w0, L.ksa, cur + nt * 8 * L.ldx, L.ldx,
                         zacc + nt * 8 * L.ldz + mt * 16, L.ldz, lane);
        else
          tile_mma<FORM>(wa_g + w0, L.ksa, cur + nt * 8 * L.ldx, L.ldx,
                         zacc + nt * 8 * L.ldz + mt * 16, L.ldz, lane);
      }
    } else {
      // f32: warp task (stream tile, group of 4 local columns), f32_tile
      const int ngrp = (3 * U + 3) / 4;
      for (int task = pt >> 5; task < ngrp * NT; task += npt >> 5) {
        const int g = task % ngrp, nt = task / ngrp;
        if (p.res_a)
          f32_tile<true>(reinterpret_cast<const float4*>(wa_s), L.ncolp, 3 * U, L.kq, g,
                         cur + nt * 8 * L.ldx, L.ldx, zacc + nt * 8 * L.ldz, L.ldz, lane);
        else
          f32_tile<false>(reinterpret_cast<const float4*>(wa_g), L.ncolp, 3 * U, L.kq, g,
                          cur + nt * 8 * L.ldx, L.ldx, zacc + nt * 8 * L.ldz, L.ldz, lane);
      }
    }
  };
  // the factored embedding's rows g [S, 384]: word w (16 bytes) is stream
  // w / WPS's row (w % WPS) / WPR (0 sig_u, 1 pred_u, 2 exc) of the shared
  // embedding at that row's code c, part w % WPR; c < 0 (a stream that
  // does not run) gives zeros
  constexpr int WPS = FACT_K / 16, WPR = FACT_E / 16;     // words a stream, a row
  auto row_word = [&](int c, int w) {
    return c < 0 ? make_uint4(0u, 0u, 0u, 0u)
                 : __ldg(reinterpret_cast<const uint4*>((const int8_t*)p.emb + (size_t)c * FACT_E) +
                         w % WPR);
  };
  auto g_word = [&](int8_t* g, int w) {
    return reinterpret_cast<uint4*>(g + (w / WPS) * FACT_LD + (w % WPS) * 16);
  };
  // stream tiles a task of g's fused product: two only where one a task
  // would leave more tasks than warps (S = 40 at Na = 384)
  constexpr int TPW = NT > 4 ? 2 : 1;
  constexpr int NGS = (NT + TPW - 1) / TPW;               // stream groups
  // g's product with this rank's input-kernel slice wf for one warp task:
  // unit tile ut (local columns q U + 16 ut + [0, 16) of the three gates
  // q) and the TPW stream tiles from nt0 (one at an odd NT's last), k in
  // order, exact int32 sums. acc[i][q] is the D fragment of stream tile
  // nt0 + i and gate q: lane (g, t) holds units 16 ut + g (c0, c1) and
  // + 8 (c2, c3) of streams 8 (nt0 + i) + 2t (c0, c2) and + 1 (c1, c3).
  // Each A fragment serves TPW stream tiles and each B fragment three
  // gates, from registers: shared memory's port, not the tensor cores,
  // bounds this product (16 bytes a lane an A load).
  auto fact_product = [&](const uint4* wf, int ut, int nt0, int (&acc)[TPW][3][4]) {
    const int ntu = U / 16;
    const int8_t* xr = gop + (nt0 * 8 + (lane >> 2)) * FACT_LD + (lane & 3) * 4;
#pragma unroll
    for (int i = 0; i < TPW; ++i)
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][q][c] = 0;
    const bool two = TPW > 1 && nt0 + 1 < NT;
#pragma unroll 2
    for (int ks = 0; ks < KSF; ++ks) {
      uint4 a[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) a[q] = wf[((size_t)(q * ntu + ut) * KSF + ks) * 32 + lane];
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        if (i > 0 && !two) continue;
        const int8_t* x = xr + i * 8 * FACT_LD + ks * 32;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(x);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(x + 16);
#pragma unroll
        for (int q = 0; q < 3; ++q) mma16832(acc[i][q], a[q], b0, b1);
      }
    }
  };
  // Where g's product runs: fused with the gate phase (fact_gate) where its
  // tasks fill the block's warps (S >= 32: 12 tasks at S = 32, 9 of two
  // stream tiles at S = 40, Na = 384); below (3 or 6 such tasks), into
  // eacc behind a barrier (fact_array) for the gate phase's per-pair
  // threads.
  constexpr bool FUSED = NT >= 4;
  // K1 and K2 get g's rows from warps 0, 4 and 8 before the codes barrier
  // where warp 0 waits on GRU-A's product anyway (K1; K2 at S >= 32); K2
  // below, where warp 0's tree is already the step's longest path, gathers
  // them after the barrier with every thread
  constexpr bool DELIVER = FREE || FUSED;
  // g's product fused with the gate phase. Warp task (unit tile, stream
  // tiles): the lane's fragments hold all three gates of the 4 TPW
  // (stream, unit) pairs it then updates, so the sums need no array and
  // no barrier between the product and the gates. The loads of the gate
  // inputs that do not depend on g go first. is_live(s): stream s runs
  // this step; cond(s): its conditioning row [3Na].
  auto fact_gate = [&](OT* nxt, auto is_live, auto cond) {
    if constexpr (FORM == FORM_Q8) {
      const int ntu = U / 16, g = lane >> 2, tq = lane & 3;
      for (int task = warp; task < ntu * NGS; task += K2_WARPS) {
        const int ut = task % ntu, nt0 = (task / ntu) * TPW;
        const int ntt = min(TPW, NT - nt0);
        float ca[TPW][4][3], sc[2][3], dg[2][3], bs[2][3];
#pragma unroll
        for (int i = 0; i < TPW; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int s = 8 * (nt0 + i) + 2 * tq + (c & 1), u = u0 + 16 * ut + g + 8 * (c >> 1);
            const bool ld = i < ntt && u < na && is_live(s);
#pragma unroll
            for (int q = 0; q < 3; ++q) ca[i][c][q] = ld ? __ldg(cond(s) + q * na + u) : 0.f;
          }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int u = u0 + 16 * ut + g + 8 * jj;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int col = q * na + u;
            sc[jj][q] = u < na ? __ldg(p.emb_scale + col) : 0.f;
            dg[jj][q] = u < na ? __ldg(p.a_diag + col) : 0.f;
            bs[jj][q] = u < na ? __ldg(p.a_bias1 + col) : 0.f;
          }
        }
        int acc[TPW][3][4];
        if (p.res_f) fact_product(wf_s, ut, nt0, acc); else fact_product(wf_g, ut, nt0, acc);
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          if (i >= ntt) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int s = 8 * (nt0 + i) + 2 * tq + (c & 1), jj = c >> 1;
            const int j = 16 * ut + g + 8 * jj, u = u0 + j;
            float h = haown[s * U + j];
            if (is_live(s) && u < na) {
              float gi[3], zr[3];
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                gi[q] = __fadd_rn(ca[i][c][q], __fmul_rn((float)acc[i][q][c], sc[jj][q]));
                zr[q] = __fadd_rn(__fadd_rn(__fmul_rn((float)zacc[s * L.ldz + q * U + j], Q8_SCALE),
                                            __fmul_rn(dg[jj][q], h)),
                                  bs[jj][q]);
              }
              h = gru_out(gi[0], zr[0], gi[1], zr[1], gi[2], zr[2], h);
              haown[s * U + j] = h;
            }
            nxt[s * L.ldx + u] = OpT<FORM>::of(h);
          }
        }
      }
    }
  };
  // g's product into eacc [S][ldz] (S <= 16): GRU-A's (column tile,
  // stream tile) tasks from warp pt >> 5 in steps of npt >> 5, one gate's
  // 16 columns a task (9 tasks at S = 8, Na = 384, where the fused tasks
  // would be 3), k in order, int32 sums
  auto fact_array = [&](int pt, int npt) {
    if constexpr (FORM == FORM_Q8) {
      const int mta = 3 * U / 16;
      for (int task = pt >> 5; task < mta * NT; task += npt >> 5) {
        const int mt = task % mta, nt = task / mta;
        const size_t w0 = (size_t)mt * KSF * 32;
        if (p.res_f)
          tile_mma<FORM_Q8>(wf_s + w0, KSF, gop + nt * 8 * FACT_LD, FACT_LD,
                            eacc + nt * 8 * L.ldz + mt * 16, L.ldz, lane);
        else
          tile_mma<FORM_Q8>(wf_g + w0, KSF, gop + nt * 8 * FACT_LD, FACT_LD,
                            eacc + nt * 8 * L.ldz + mt * 16, L.ldz, lane);
      }
    }
  };
  // this rank's slice of the new operand to the other blocks, 16 bytes a store
  auto send_slice = [&](OT* nxt) {
    constexpr int EPW = 16 / F::ESZ;                 // operand elements a word
    const int wps = U / EPW;                         // words a stream's slice
    for (int i = tid; i < (C - 1) * S * wps; i += K2_THREADS) {
      const int c = (rank + 1 + i / (S * wps)) % C, s = (i / wps) % S, w = i % wps;
      const int off = s * L.ldx + u0 + w * EPW;
      *reinterpret_cast<uint4*>(cluster.map_shared_rank(nxt, c) + off) =
          *reinterpret_cast<const uint4*>(nxt + off);
    }
  };
  // f32 K1: this rank's part of GRU-B's input product over its own units,
  // for every stream s and 4 columns c: sum over j in order of
  // h_a[s][u0 + j] b_in[u0 + j][c] (the rows in brow), 16 bytes to the
  // tail's owner of s (gbin[rank][s - owner SO]), so that no block reads
  // all of b_in a step
  auto send_b_parts = [&](const OT* hn) {
    const int nq = L.nb3p / 4, units = min(U, na - u0);
    for (int i = tid; i < S * nq; i += K2_THREADS) {
      const int s = i / nq, c0 = 4 * (i % nq);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int j = 0; j < units; ++j) {
        const float h = (float)hn[s * L.ldx + u0 + j];
        const float4 wv = *reinterpret_cast<const float4*>(brow + j * L.nb3p + c0);
        acc[0] = fmaf(h, wv.x, acc[0]);
        acc[1] = fmaf(h, wv.y, acc[1]);
        acc[2] = fmaf(h, wv.z, acc[2]);
        acc[3] = fmaf(h, wv.w, acc[3]);
      }
      const int owner = s / SO, sl = s - owner * SO;
      *reinterpret_cast<float4*>(cluster.map_shared_rank(gbin, owner) +
                                 (rank * SO + sl) * L.nb3p + c0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  };

  if constexpr (TF) {
    // ---- K3: the teacher-forced run
    if (total > 0) {
      const int* cmax = cnt + nbk * S;
      const size_t nstep = (size_t)nbk * p.blk;          // code triples a stream
      const W* emb = (const W*)p.emb;
      // the step after (k, t) that the cluster runs; k == nbk past the last
      auto step_after = [&](int& k, int& t) {
        if (k >= nbk) return;
        if (++t >= cmax[k]) {
          t = 0;
          do { ++k; } while (k < nbk && cmax[k] == 0);
        }
      };
      auto live_at = [&](int s, int k, int t) { return k < nbk && t < cnt[k * S + s]; };
      // thread tid's first NT (stream, unit) pairs, i = tid + pp K2_THREADS,
      // have their gate inputs loaded ahead (all of them where U <= 48)
      auto pair_on = [&](int pp) {
        const int i = tid + pp * K2_THREADS;
        return i < S * U && u0 + i % U < na;
      };
      float bias[NT][3], diag[NT][3], scale[NT][3];
      int cd[NT][3];
      GateRaw<FORM> raw[NT];
#pragma unroll
      for (int pp = 0; pp < NT; ++pp) {
        const int u = u0 + (tid + pp * K2_THREADS) % U;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int col = q * na + u;
          const bool on = pair_on(pp);
          bias[pp][q] = on ? __ldg(p.a_bias1 + col) : 0.f;
          diag[pp][q] = FORM == FORM_Q8 && on ? __ldg(p.a_diag + col) : 0.f;
          scale[pp][q] = FORM == FORM_Q8 && on ? __ldg(p.emb_scale + col) : 0.f;
          cd[pp][q] = 0;
        }
      }
      // the code bytes of step (k, t) for the live pairs (the factored
      // embedding gathers its rows by stream instead, gather_g)
      auto load_codes = [&](int k, int t) {
        if (fact) return;
#pragma unroll
        for (int pp = 0; pp < NT; ++pp) {
          const int s = (tid + pp * K2_THREADS) / U;
          if (!pair_on(pp) || !live_at(s, k, t)) continue;
          const uint8_t* c3 = p.codes + ((size_t)(b0 + s) * nstep + (size_t)k * p.blk + t) * 3;
#pragma unroll
          for (int r = 0; r < 3; ++r) cd[pp][r] = __ldg(c3 + r);
        }
      };
      // the raw gate inputs of a pair at step (k, t) on codes c (factored:
      // the conditioning only; the embedding's part is g's product, eacc)
      auto gather = [&](GateRaw<FORM>& g, int s, int u, int k, const int* c) {
        const float* ca = p.cond_a + ((size_t)(b0 + s) * nbk + k) * na3;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int col = q * na + u;
          g.ca[q] = __ldg(ca + col);
          if (fact) continue;
#pragma unroll
          for (int r = 0; r < 3; ++r) g.e[r][q] = __ldg(emb + (size_t)(256 * r + c[r]) * na3 + col);
        }
      };
      // the factored embedding's code of word w of g at step (k, t); -1
      // where its stream does not run
      auto g_code = [&](int w, int k, int t) {
        const int s = w / WPS;
        return live_at(s, k, t) ? (int)__ldg(p.codes + ((size_t)(b0 + s) * nstep +
                                                        (size_t)k * p.blk + t) * 3 + (w % WPS) / WPR)
                                : -1;
      };
      // the factored embedding: the rows g of step (k, t) into g by the
      // nine warps of GRU-A's product (index pt9 of 288), their codes' loads
      // all in flight, then the rows'
      const int pt9 = (warp - 1 - warp / 4) * 32 + lane;
      auto gather_rows = [&](int k, int t) {
        constexpr int GWT = (S * WPS + 287) / 288;        // words a thread
        int c[GWT];
        uint4 v[GWT];
#pragma unroll
        for (int i = 0; i < GWT; ++i) {
          const int w = pt9 + 288 * i;
          c[i] = w < S * WPS ? g_code(w, k, t) : -1;
        }
#pragma unroll
        for (int i = 0; i < GWT; ++i) v[i] = row_word(c[i], pt9 + 288 * i);
#pragma unroll
        for (int i = 0; i < GWT; ++i)
          if (pt9 + 288 * i < S * WPS) *g_word(gop, pt9 + 288 * i) = v[i];
      };
      // the gate inputs of step (k, t) loaded ahead (the fused factored
      // form loads its conditioning in fact_gate)
      auto gather_all = [&](int k, int t) {
        if (fact && FUSED) return;
#pragma unroll
        for (int pp = 0; pp < NT; ++pp) {
          const int i = tid + pp * K2_THREADS, s = i / U;
          if (pair_on(pp) && live_at(s, k, t)) gather(raw[pp], s, u0 + i % U, k, cd[pp]);
        }
      };
      // gate q's input: the embedding rows (factored: g's product of stream
      // s, column q U + j) and the conditioning summed in K2's order
      auto gate_in = [&](const GateRaw<FORM>& g, int q, float sc, int s, int j) {
        if constexpr (FORM == FORM_Q8) {
          const int e = fact ? eacc[s * L.ldz + q * U + j]
                             : (int)g.e[0][q] + (int)g.e[1][q] + (int)g.e[2][q];
          return __fadd_rn(g.ca[q], __fmul_rn((float)e, sc));
        } else {
          const float e = __fadd_rn(__fadd_rn(wf(g.e[0][q]), wf(g.e[1][q])),
                                    wf(g.e[2][q]));
          return __fadd_rn(g.ca[q], e);
        }
      };
      // the new h_a of a pair from its gate inputs and this step's products
      auto gate = [&](const GateRaw<FORM>& g, int s, int j, float h, const float* bs,
                      const float* dg, const float* sc) {
        float gi[3], zr[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const Acc acc = zacc[s * L.ldz + q * U + j];
          gi[q] = gate_in(g, q, sc[q], s, j);
          if (FORM == FORM_Q8)
            zr[q] = __fadd_rn(__fadd_rn(__fmul_rn((float)acc, Q8_SCALE), __fmul_rn(dg[q], h)), bs[q]);
          else
            zr[q] = __fadd_rn((float)acc, bs[q]);
        }
        return gru_out(gi[0], zr[0], gi[1], zr[1], gi[2], zr[2], h);
      };
      // GRU-B's products for this rank's tile of 8 tail rows, by the 96
      // threads of warps 0, 4 and 8 (gw = warp / 4)
      auto gru_b_products = [&](const OT* cur, int gw) {
        if (so == 0) return;
        if constexpr (F::MMA) {
          const int mtb = 3 * nbp / 16, ksb = L.ksa + L.ksbr;
          const OT* xa = cur + s0 * L.ldx;
          for (int task = gw; task < 2 * mtb; task += 3) {
            const int part = task / mtb, mt = task % mtb;
            auto tile = [&](const uint4* wb) {
              if (part == 0)
                tile_mma<FORM>(wb + (size_t)mt * ksb * 32, L.ksa, xa, L.ldx, gin + mt * 16,
                               L.ldg, lane);
              else
                tile_mma<FORM>(wb + ((size_t)mt * ksb + L.ksa) * 32, L.ksbr, hbop, L.ldb,
                               grec + mt * 16, L.ldg, lane);
            };
            if (p.res_b) tile(wb_s); else tile(wb_g);
          }
        } else {
          for (int o = gw * 32 + lane; o < so * nb3; o += 96) {
            const int sl = o / nb3, c = o % nb3, s = s0 + sl;
            float ai = 0.f, ar = 0.f;
#pragma unroll 16
            for (int k = 0; k < na; ++k) ai += cur[s * L.ldx + k] * __ldg(p.b_in + (size_t)k * nb3 + c);
            for (int k = 0; k < nb; ++k) ar += hbop[sl * L.ldb + k] * __ldg(p.b_rec + (size_t)k * nb3 + c);
            const int pc = (c / nb) * nbp + c % nb;
            gin[sl * L.ldg + pc] = ai;
            grec[sl * L.ldg + pc] = ar;
          }
        }
      };
      // GRU-B's update of step (k, t) from its products, thread (tail
      // stream, unit) from i0 in steps of `stride`
      auto gru_b_update = [&](int k, int t, int i0, int stride) {
        for (int i = i0; i < so * nb; i += stride) {
          const int sl = i / nb, u = i % nb, s = s0 + sl;
          if (!live_at(s, k, t)) continue;
          const float* cb = p.cond_b + ((size_t)(b0 + s) * nbk + k) * nb3;
          float gi[3], gr[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int c = q * nb + u;
            const Acc ai = gin[sl * L.ldg + q * nbp + u], ar = grec[sl * L.ldg + q * nbp + u];
            if (FORM == FORM_Q8) {
              gi[q] = __fadd_rn(__ldg(cb + c), __fmul_rn((float)ai, Q8_SCALE));
              gr[q] = __fadd_rn(__fmul_rn((float)ar, Q8_SCALE), __ldg(p.b_bias1 + c));
            } else {
              gi[q] = __fadd_rn(__ldg(cb + c), (float)ai);
              gr[q] = __fadd_rn((float)ar, __ldg(p.b_bias1 + c));
            }
          }
          const float h = gru_out(gi[0], gr[0], gi[1], gr[1], gi[2], gr[2], hbf[i]);
          hbf[i] = h;
          hbop[sl * L.ldb + u] = OpT<FORM>::of(h);
        }
      };

      // (k, t) the step, (k1, t1) and (k2, t2) the two after it, (kb, tb)
      // the one before: GRU-B's step
      int k = 0, t = 0;
      while (cmax[k] == 0) ++k;
      int k1 = k, t1 = t;
      step_after(k1, t1);
      int k2 = k1, t2 = t1;
      step_after(k2, t2);
      int kb = k, tb = t;
      // step 0's codes and gate inputs; step 1's codes
      load_codes(k, t);
      gather_all(k, t);
      load_codes(k1, t1);
      if (fact) {   // step 0's rows g (and, unfused, their product)
        for (int w = tid; w < S * WPS; w += K2_THREADS) *g_word(gop, w) = row_word(g_code(w, k, t), w);
        if (!FUSED) {
          __syncthreads();
          fact_array(tid, K2_THREADS);
        }
      }
      const bool gru_b_warp = (warp & 3) == 0;
      cluster.sync();   // every block runs and is set up before remote stores

      for (int j = 0;; ++j) {
        const OT* cur = hop + (j & 1) * hstride;
        // ---- GRU-A's product of step j beside GRU-B's products of step j-1
        if (!gru_b_warp) {
          if (j < total) gru_a_product(cur, pt9, 288);
        } else if (j > 0) {
          gru_b_products(cur, warp >> 2);
        }
        if (j == total) break;
        __syncthreads();

        // ---- gate phase: thread (stream, unit) forms its new h_a from the
        // gate inputs loaded a step ahead (factored: fused with g's product
        // on the rows gathered in the window before, or reading that
        // product, run there, from eacc)
        OT* nxt = hop + ((j + 1) & 1) * hstride;
        if (fact && FUSED) {
          fact_gate(nxt, [&](int s) { return live_at(s, k, t); },
                    [&](int s) { return p.cond_a + ((size_t)(b0 + s) * nbk + k) * na3; });
        } else {
#pragma unroll
          for (int pp = 0; pp < NT; ++pp) {
            const int i = tid + pp * K2_THREADS;
            if (i >= S * U) break;
            const int s = i / U, jj = i % U, u = u0 + jj;
            float h = haown[i];
            if (u < na && live_at(s, k, t)) {
              h = gate(raw[pp], s, jj, h, bias[pp], diag[pp], scale[pp]);
              haown[i] = h;
            }
            nxt[s * L.ldx + u] = OpT<FORM>::of(h);
          }
          // pairs past the first NT (ranks of more than 48 units): gathered here
          for (int i = tid + NT * K2_THREADS; i < S * U; i += K2_THREADS) {
            const int s = i / U, jj = i % U, u = u0 + jj;
            float h = haown[i];
            if (u < na && live_at(s, k, t)) {
              const uint8_t* c3 = p.codes + ((size_t)(b0 + s) * nstep + (size_t)k * p.blk + t) * 3;
              const int c[3] = {fact ? 0 : __ldg(c3), fact ? 0 : __ldg(c3 + 1),
                                fact ? 0 : __ldg(c3 + 2)};
              GateRaw<FORM> g;
              gather(g, s, u, k, c);
              float bs[3], dg[3], sc[3];
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                bs[q] = __ldg(p.a_bias1 + q * na + u);
                dg[q] = FORM == FORM_Q8 ? __ldg(p.a_diag + q * na + u) : 0.f;
                sc[q] = FORM == FORM_Q8 ? __ldg(p.emb_scale + q * na + u) : 0.f;
              }
              h = gate(g, s, jj, h, bs, dg, sc);
              haown[i] = h;
            }
            nxt[s * L.ldx + u] = OpT<FORM>::of(h);
          }
        }
        __syncthreads();
        send_slice(nxt);
        // the cluster barrier: the new operand complete in every block, and
        // the buffer the next step writes no longer read. Between its arrive
        // and its wait, GRU-B's update of step j-1 (warps 0, 4, 8) and the
        // loads of step j+1's gate inputs and step j+2's codes (factored:
        // the other nine load step j+1's rows g, which step j's gate phase
        // no longer reads, and, unfused, run their product into eacc behind
        // a barrier of the nine; the next step's block barrier orders both).
        asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
        if (gru_b_warp && j > 0) {
          gru_b_update(kb, tb, (warp >> 2) * 32 + lane, 96);
          asm volatile("bar.sync 1, 96;\n" ::: "memory");
        }
        if (fact && !gru_b_warp) {
          gather_rows(k1, t1);
          if (!FUSED) {
            asm volatile("bar.sync 2, 288;\n" ::: "memory");
            fact_array(pt9, 288);
          }
        }
        kb = k; tb = t;
        k = k1; t = t1;
        k1 = k2; t1 = t2;
        step_after(k2, t2);
        gather_all(k, t);
        load_codes(k1, t1);
        asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      }
      // GRU-B's update of the last step
      __syncthreads();
      gru_b_update(kb, tb, tid, K2_THREADS);
    }

    // ---- the carried state: each rank its own h_a units, the tail's owner
    // its streams' h_b and KISS99 words, advanced by two draws a step run
    __syncthreads();
    for (int i = tid; i < nact * U; i += K2_THREADS)
      if (u0 + i % U < na) p.ha_out[(size_t)(b0 + i / U) * na + u0 + i % U] = haown[i];
    const int ntail = max(0, min(so, nact - s0));
    for (int i = tid; i < ntail * nb; i += K2_THREADS)
      p.hb_out[(size_t)(b0 + s0 + i / nb) * nb + i % nb] = hbf[i];
    if (warp == 0 && lane < ntail) {
      const size_t g = (size_t)(b0 + s0 + lane);
      int draws = 0;
      for (int k = 0; k < nbk; ++k) draws += 2 * cnt[k * S + s0 + lane];
      unsigned st[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) st[q] = (unsigned)p.rng_in[g * 4 + q];
      for (int i = 0; i < draws; ++i) kiss99(st);
#pragma unroll
      for (int q = 0; q < 4; ++q) p.rng_out[g * 4 + q] = (long long)st[q];
    }
    return;
  }

  // warp 0, lane l: stream s0 + l's scalar state, in registers
  const int s_own = s0 + lane;
  const bool own_on = warp == 0 && lane < so && s_own < nact;
  float sig[LPC_ORDER], lpc[LPC_ORDER];
  unsigned st[4] = {1u, 1u, 1u, 1u};
  float de = 0.f, pred = 0.f, pl_cur = 0.f, pl_next = 0.f;
  int m_cur = 1, m_next = 1, exc = 0;
  unsigned r2_keep = 0;                     // the second KISS99 word of a sampled step
#pragma unroll
  for (int j = 0; j < LPC_ORDER; ++j) sig[j] = lpc[j] = 0.f;
  if (own_on) {
    const size_t g = (size_t)(b0 + s_own);
#pragma unroll
    for (int j = 0; j < LPC_ORDER; ++j) {
      sig[j] = p.sig_in[g * LPC_ORDER + j];
      lpc[j] = p.lpc[g * LPC_ORDER + j];
    }
    de = p.de_in[g];
    exc = p.exc_in[g];
#pragma unroll
    for (int k = 0; k < 4; ++k) st[k] = (unsigned)p.rng_in[g * 4 + k];
    if constexpr (!FREE) {
      m_next = p.mode[g * n];
      pl_next = p.preload[g * n];
    }
  }
  if (!FREE && warp == 0 && lane < S) code[CW * lane + 2] = exc;
  for (int i = tid; i < 256; i += K2_THREADS) table[i] = p.logit_table[i];
  cluster.sync();   // every block runs and is set up before remote stores

  for (int t = 0; t <= n; ++t) {
    // ---- warp 0: the tree and the PCM of step t-1, the codes of step t
    if (warp == 0) {
      if (t > 0 && own_on) {
        const size_t po = (size_t)(b0 + s_own) * n + (t - 1);
        if (!FREE && !(m_cur & 1)) {
          if (rank == 0) p.pcm[po] = 0.f;      // advance off: frozen, sample 0
        } else {
          int val = 0;
          if (FREE || (p.sampled && !(m_cur & 2))) {
            // levels 4-7; the words were drawn and levels 0-3 descended
            // mid-step. At level 4 + lb the node is (1 << (4 + lb)) | val.
            val = top[lane];
            const float* lg = logits + lane * 32 + 16;
#pragma unroll
            for (int lb = 0; lb < 4; ++lb) {
              const unsigned byte = (r2_keep >> (8 * lb)) & 0xFFu;
              const float diff = __fsub_rn(lg[(1 << lb) - 1 + (val & ((1 << lb) - 1))],
                                           table[byte]);
              val = (val << 1) | (diff > 0.f ? 1 : 0);
            }
          } else {
            kiss99(st);                         // the step's two draws, unused
            kiss99(st);
          }
          float pcm;
          if (!FREE && (m_cur & 2)) {
            // teacher-force: the target gives the sample and its excitation
            pcm = __fsub_rn(pl_cur, __fmul_rn(PREEMPH, de));
            val = lin2ulaw(__fsub_rn(pcm, pred));
          } else {
            pcm = __fadd_rn(pred, ulaw2lin(val));
          }
#pragma unroll
          for (int j = LPC_ORDER - 1; j > 0; --j) sig[j] = sig[j - 1];
          sig[0] = pcm;
          exc = val;
          if (!FREE) code[CW * s_own + 2] = val;
          de = __fadd_rn(pcm, __fmul_rn(PREEMPH, de));
          if (FREE || rank == 0)
            p.pcm[po] = floorf(__fadd_rn(0.5f, fminf(fmaxf(de, -32767.f), 32767.f)));
        }
      }
      if (t == n) break;
      int m = 0;
      if (own_on) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < LPC_ORDER; ++j) acc = __fadd_rn(acc, __fmul_rn(sig[j], lpc[j]));
        pred = -acc;
        if constexpr (FREE) {
          // the step's codes to every block of the cluster: the gate phase
          // gathers the embedding rows of all S streams
          const int4 c4 = make_int4(lin2ulaw(sig[0]), lin2ulaw(-acc), exc, 0);
          for (int c = 0; c < C; ++c)
            *reinterpret_cast<int4*>((c == rank ? code : cluster.map_shared_rank(code, c)) +
                                     CW * s_own) = c4;
        } else {
          code[CW * s_own] = lin2ulaw(sig[0]);
          code[CW * s_own + 1] = lin2ulaw(-acc);
          m = m_cur = m_next;
          pl_cur = pl_next;
          if (t + 1 < n) {                  // next step's words, a step ahead
            const size_t g = (size_t)(b0 + s_own) * n + t + 1;
            m_next = p.mode[g];
            pl_next = p.preload[g];
          }
        }
      }
      if constexpr (!FREE) {
        const unsigned live = __ballot_sync(0xffffffffu, own_on && (m & 1));
        const unsigned need = __ballot_sync(0xffffffffu, own_on && (m & 1) && !(m & 2));
        if (lane == 0) {
          flags[0] = live;
          flags[1] = p.sampled ? need : 0u;
        }
      }
    } else if (t < n) {
      // ---- warps 1..: GRU-A's product of step t on the operand of h_a
      const OT* cur = hop + (t & 1) * hnext;
      if constexpr (F::MMA) {
        // warps 4 and 8 share warp 0's scheduler, whose tree and codes are
        // the step's critical path: the other nine take the tiles
        if (warp & 3) gru_a_product(cur, (warp - 1 - warp / 4) * 32 + lane, 288);
      } else {
        gru_a_product(cur, tid - 32, K2_THREADS - 32);
      }
    }
    // ---- the factored embedding: once warp 0 has this rank's codes of
    // step t, warps 0, 4 and 8 (which take no GRU-A tile) load the rows g
    // of its tail streams (all S in the masked form) and store them into
    // every block's g (masked: its own) while the other nine run GRU-A's
    // product; the codes barrier orders them. A block reads g only between
    // that barrier and the next operand barrier, which no rank passes
    // before every block's gate phase of step t is done.
    if (fact && DELIVER && t < n && (warp & 3) == 0) {
      asm volatile("bar.sync 1, 96;\n" ::: "memory");
      constexpr int GW = ((SPLIT ? 8 : S) * WPS + 95) / 96;   // words a thread
      const int d = (warp >> 2) * 32 + lane;
      const unsigned lv = FREE ? 0u : flags[0];
      uint4 v[GW];
#pragma unroll
      for (int i = 0; i < GW; ++i) {
        const int w = d + 96 * i, s = s0 + w / WPS;
        const bool on = w < so * WPS && s < nact && (FREE || ((lv >> s) & 1u));
        v[i] = row_word(on ? code[CW * s + (w % WPS) / WPR] : -1, w);
      }
#pragma unroll
      for (int i = 0; i < GW; ++i) {
        const int w = d + 96 * i;
        if (w >= so * WPS) continue;
        uint4* dst = g_word(gop, s0 * WPS + w);
        if constexpr (FREE) {
          for (int c = 0; c < C; ++c) *(c == rank ? dst : cluster.map_shared_rank(dst, c)) = v[i];
        } else {
          *dst = v[i];
        }
      }
    }
    if (t == n) break;
    // free-running: every block's codes of step t have arrived
    if constexpr (FREE) cluster.sync(); else __syncthreads();
    const unsigned live = FREE ? 0u : flags[0];
    const unsigned need = FREE ? 0u : flags[1];
    auto is_live = [&](int s) { return FREE ? s < nact : ((live >> s) & 1u) != 0u; };
    if (fact && !DELIVER) {
      // K2 at S <= 16: the live streams' rows g, every thread a word
      for (int w = tid; w < S * WPS; w += K2_THREADS)
        *g_word(gop, w) = row_word(is_live(w / WPS) ? code[CW * (w / WPS) + (w % WPS) / WPR] : -1, w);
      __syncthreads();
    }

    // ---- gate phase: thread (stream, unit) forms its new h_a and its operand
    // copy (factored: with g's product, fused or from eacc), then the block
    // sends its slice to every block of the cluster
    OT* nxt = hop + ((t + 1) & 1) * hnext;
    if (fact && FUSED) {
      fact_gate(nxt, is_live, [&](int s) { return p.cond_a + (size_t)(b0 + s) * na3; });
    } else {
      if (fact) {
        fact_array(tid, K2_THREADS);
        __syncthreads();
      }
      for (int i0 = tid; i0 < S * U; i0 += NT * K2_THREADS) {
        // this thread's pairs' reads from L2 first, all in flight together
        float g[NT][3], bias[NT][3], diag[NT][3];
#pragma unroll
        for (int pp = 0; pp < NT; ++pp) {
          const int i = i0 + pp * K2_THREADS;
          const int s = i / U, u = u0 + i % U;
          if (i >= S * U || !is_live(s) || u >= na) continue;
          const float* ca = p.cond_a + (size_t)(b0 + s) * na3;
          const size_t r0 = (size_t)code[CW * s] * na3, r1 = (size_t)(256 + code[CW * s + 1]) * na3,
                       r2 = (size_t)(512 + code[CW * s + 2]) * na3;
          const W* emb = (const W*)p.emb;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int col = q * na + u;
            if (FORM == FORM_Q8) {
              const int e = fact ? eacc[s * L.ldz + q * U + i % U]
                                 : ldw(emb, r0 + col) + ldw(emb, r1 + col) + ldw(emb, r2 + col);
              g[pp][q] = __fadd_rn(__ldg(ca + col), __fmul_rn((float)e, __ldg(p.emb_scale + col)));
              diag[pp][q] = __ldg(p.a_diag + col);
            } else {
              const float e = __fadd_rn(__fadd_rn((float)ldw(emb, r0 + col), (float)ldw(emb, r1 + col)),
                                        (float)ldw(emb, r2 + col));
              g[pp][q] = __fadd_rn(__ldg(ca + col), e);
            }
            bias[pp][q] = __ldg(p.a_bias1 + col);
          }
        }
#pragma unroll
        for (int pp = 0; pp < NT; ++pp) {
          const int i = i0 + pp * K2_THREADS;
          if (i >= S * U) break;
          const int s = i / U, j = i % U, u = u0 + j;
          float h = haown[i];
          if (is_live(s) && u < na) {
            float zr[3];
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              const Acc acc = zacc[s * L.ldz + q * U + j];
              if (FORM == FORM_Q8)
                zr[q] = __fadd_rn(__fadd_rn(__fmul_rn((float)acc, Q8_SCALE), __fmul_rn(diag[pp][q], h)),
                                  bias[pp][q]);
              else
                zr[q] = __fadd_rn((float)acc, bias[pp][q]);
            }
            h = gru_out(g[pp][0], zr[0], g[pp][1], zr[1], g[pp][2], zr[2], h);
            haown[i] = h;
          }
          nxt[s * L.ldx + u] = OpT<FORM>::of(h);
        }
      }
    }
    __syncthreads();
    send_slice(nxt);
    if constexpr (FREE && !F::MMA) send_b_parts(nxt);
    // the new operand copy is complete in every block; nobody still reads the
    // buffer the next step overwrites (f32 K1: the codes barrier saw every
    // block's product of this step done before any slice was sent)
    cluster.sync();

    // ---- GRU-B's products on the new h_a and the old h_b, for the tail
    // streams: all S (masked) or this rank's tile of 8 rows from s0
    // (free-running; rows past its SO streams are computed and unused)
    if (so == 0) {
      // a rank past the last stream has no tail
    } else if constexpr (F::MMA) {
      constexpr int NTB = FREE ? 1 : NT;
      const int mtb = 3 * nbp / 16;
      const int ksb = L.ksa + L.ksbr;
      const OT* xa = nxt + s0 * L.ldx;
      for (int task = warp; task < 2 * mtb * NTB; task += K2_WARPS) {
        const int part = task / (mtb * NTB), mt = task % mtb, nt = (task / mtb) % NTB;
        auto gru_b_tile = [&](const uint4* wb) {
          if (part == 0)
            tile_mma<FORM>(wb + (size_t)mt * ksb * 32, L.ksa, xa + nt * 8 * L.ldx, L.ldx,
                           gin + nt * 8 * L.ldg + mt * 16, L.ldg, lane);
          else
            tile_mma<FORM>(wb + ((size_t)mt * ksb + L.ksa) * 32, L.ksbr, hbop + nt * 8 * L.ldb,
                           L.ldb, grec + nt * 8 * L.ldg + mt * 16, L.ldg, lane);
        };
        if (p.res_b) gru_b_tile(wb_s); else gru_b_tile(wb_g);
      }
    } else {
      // f32: the input product, K1's the ranks' parts (gbin) added in rank
      // order, K2's Na deep from L2; the recurrent product Nb deep from L2
      for (int o = tid; o < so * nb3; o += K2_THREADS) {
        const int sl = o / nb3, c = o % nb3, s = s0 + sl;
        float ai = 0.f, ar = 0.f;
        if constexpr (FREE) {
          ai = gbin[sl * L.nb3p + c];
          for (int r = 1; r < C; ++r) ai = __fadd_rn(ai, gbin[(r * SO + sl) * L.nb3p + c]);
        } else {
#pragma unroll 16
          for (int k = 0; k < na; ++k) ai += nxt[s * L.ldx + k] * __ldg(p.b_in + (size_t)k * nb3 + c);
        }
#pragma unroll 16
        for (int k = 0; k < nb; ++k) ar += hbop[sl * L.ldb + k] * __ldg(p.b_rec + (size_t)k * nb3 + c);
        const int pc = (c / nb) * nbp + c % nb;       // the padded layout's column
        gin[sl * L.ldg + pc] = ai;
        grec[sl * L.ldg + pc] = ar;
      }
    }
    __syncthreads();

    // ---- GRU-B's update, thread (tail stream, unit)
    for (int i = tid; i < so * nb; i += K2_THREADS) {
      const int sl = i / nb, u = i % nb, s = s0 + sl;
      float h = hbf[i];
      if (is_live(s)) {
        const float* cb = p.cond_b + (size_t)(b0 + s) * nb3;
        float gi[3], gr[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int c = q * nb + u;
          const Acc ai = gin[sl * L.ldg + q * nbp + u], ar = grec[sl * L.ldg + q * nbp + u];
          if (FORM == FORM_Q8) {
            gi[q] = __fadd_rn(cb[c], __fmul_rn((float)ai, Q8_SCALE));
            gr[q] = __fadd_rn(__fmul_rn((float)ar, Q8_SCALE), p.b_bias1[c]);
          } else {
            gi[q] = __fadd_rn(cb[c], (float)ai);
            gr[q] = __fadd_rn((float)ar, p.b_bias1[c]);
          }
        }
        h = gru_out(gi[0], gr[0], gi[1], gr[1], gi[2], gr[2], h);
        hbf[i] = h;
        hbop[sl * L.ldb + u] = OpT<FORM>::of(h);
      }
    }
    __syncthreads();

    // ---- the dual-FC logits of the nodes the tree visits, for the tail
    // streams that sample: the 15 nodes of levels 0-3; warp 0 draws the
    // step's two KISS99 words and descends levels 0-3; then the 15 nodes of
    // levels 4-7 under the node reached. Levels 4-7 are descended in the
    // next step's first phase.
    auto samples = [&](int sl) {
      return FREE ? s0 + sl < nact : ((need >> sl) & 1u) != 0u;
    };
    if (FREE ? so > 0 && s0 < nact : need != 0u) {
      for (int o = tid; o < so * 15; o += K2_THREADS) {
        const int sl = o / 15, j = o % 15;
        if (samples(sl)) logits[sl * 32 + j] = node_logit(p, hbf + sl * nb, nb, j + 1);
      }
      __syncthreads();
      if (warp == 0 && lane < so && samples(lane)) {
        const unsigned r1 = kiss99(st);
        r2_keep = kiss99(st);
        int val = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const unsigned byte = (r1 >> (8 * b)) & 0xFFu;
          const float diff = __fsub_rn(logits[lane * 32 + (1 << b) - 1 + val], table[byte]);
          val = (val << 1) | (diff > 0.f ? 1 : 0);
        }
        top[lane] = val;
      }
      __syncthreads();
      for (int o = tid; o < so * 15; o += K2_THREADS) {
        const int sl = o / 15, j = o % 15;
        if (!samples(sl)) continue;
        const int lb = j >= 7 ? 3 : (j >= 3 ? 2 : (j >= 1 ? 1 : 0));
        const int nd = (1 << (4 + lb)) | (top[sl] << lb) | (j + 1 - (1 << lb));
        logits[sl * 32 + 16 + j] = node_logit(p, hbf + sl * nb, nb, nd);
      }
    }
    __syncthreads();
  }

  // ---- the carried state: each rank its own h_a units, the tail's owner
  // (rank 0 in the masked form) the rest
  __syncthreads();
  for (int i = tid; i < nact * U; i += K2_THREADS)
    if (u0 + i % U < na) p.ha_out[(size_t)(b0 + i / U) * na + u0 + i % U] = haown[i];
  if (!FREE && rank != 0) return;
  const int ntail = max(0, min(so, nact - s0));
  for (int i = tid; i < ntail * nb; i += K2_THREADS)
    p.hb_out[(size_t)(b0 + s0 + i / nb) * nb + i % nb] = hbf[i];
  if (own_on) {
    const size_t g = (size_t)(b0 + s_own);
#pragma unroll
    for (int j = 0; j < LPC_ORDER; ++j) p.sig_out[g * LPC_ORDER + j] = sig[j];
    p.de_out[g] = de;
    p.exc_out[g] = exc;
#pragma unroll
    for (int k = 0; k < 4; ++k) p.rng_out[g * 4 + k] = (long long)st[k];
  }
}

typedef void (*K2Kernel)(K2Args);

// the kernel of a form, a stream tiling (S = 8 nt), a kind and the factored
// embedding (q8 only), null if there is none: K2 and K3 at S = 8, 16 and
// 32, K1 (free-running) at 8, 16, 32 and 40, each in all three forms.
K2Kernel kernel_for(int form, int nt, int kind, int fact) {
  switch ((fact ? 256 : 0) + kind * 64 + form * 8 + nt) {
#define K2_CASE(KIND, FORM, NT) \
    case KIND * 64 + FORM * 8 + NT: return masked_loop_kernel<FORM, NT, KIND, false>;
#define K2_FACT(KIND, NT) \
    case 256 + KIND * 64 + FORM_Q8 * 8 + NT: return masked_loop_kernel<FORM_Q8, NT, KIND, true>;
    K2_CASE(KIND_MASKED, FORM_F32, 1) K2_CASE(KIND_MASKED, FORM_F32, 2)
    K2_CASE(KIND_MASKED, FORM_F32, 4) K2_CASE(KIND_MASKED, FORM_BF16, 1)
    K2_CASE(KIND_MASKED, FORM_BF16, 2) K2_CASE(KIND_MASKED, FORM_BF16, 4)
    K2_CASE(KIND_MASKED, FORM_Q8, 1) K2_CASE(KIND_MASKED, FORM_Q8, 2)
    K2_CASE(KIND_MASKED, FORM_Q8, 4)
    K2_CASE(KIND_FREE, FORM_F32, 1) K2_CASE(KIND_FREE, FORM_F32, 2)
    K2_CASE(KIND_FREE, FORM_F32, 4) K2_CASE(KIND_FREE, FORM_F32, 5)
    K2_CASE(KIND_FREE, FORM_BF16, 1) K2_CASE(KIND_FREE, FORM_BF16, 2)
    K2_CASE(KIND_FREE, FORM_BF16, 4) K2_CASE(KIND_FREE, FORM_BF16, 5)
    K2_CASE(KIND_FREE, FORM_Q8, 1) K2_CASE(KIND_FREE, FORM_Q8, 2)
    K2_CASE(KIND_FREE, FORM_Q8, 4) K2_CASE(KIND_FREE, FORM_Q8, 5)
    K2_CASE(KIND_TF, FORM_F32, 1) K2_CASE(KIND_TF, FORM_F32, 2)
    K2_CASE(KIND_TF, FORM_F32, 4) K2_CASE(KIND_TF, FORM_BF16, 1)
    K2_CASE(KIND_TF, FORM_BF16, 2) K2_CASE(KIND_TF, FORM_BF16, 4)
    K2_CASE(KIND_TF, FORM_Q8, 1) K2_CASE(KIND_TF, FORM_Q8, 2)
    K2_CASE(KIND_TF, FORM_Q8, 4)
    K2_FACT(KIND_MASKED, 1) K2_FACT(KIND_MASKED, 2) K2_FACT(KIND_MASKED, 4)
    K2_FACT(KIND_FREE, 1) K2_FACT(KIND_FREE, 2) K2_FACT(KIND_FREE, 4) K2_FACT(KIND_FREE, 5)
    K2_FACT(KIND_TF, 1) K2_FACT(KIND_TF, 2) K2_FACT(KIND_TF, 4)
#undef K2_CASE
#undef K2_FACT
    default: return nullptr;
  }
}

// the kernel's shared memory and, past the portable 8 blocks, its leave to
// run on clusters of up to 16 (the f32 form)
cudaError_t k2_attributes(K2Kernel k, int cluster, int smem) {
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

cudaLaunchConfig_t k2_config(int grid, int cluster, int smem, cudaStream_t stream,
                             cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(K2_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// launch the kernel k on clusters of `cluster` blocks, one per 8 nt streams
int k2_launch(K2Kernel k, const K2Args& a, int nt, int smem, void* stream) {
  cudaError_t e = k2_attributes(k, a.cluster, smem);
  if (e != cudaSuccess) return (int)e;
  const int clusters = (a.batch + 8 * nt - 1) / (8 * nt);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = k2_config(clusters * a.cluster, a.cluster, smem, (cudaStream_t)stream,
                                     &attr);
  e = cudaLaunchKernelEx(&cfg, k, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the factored embedding's arguments: q8 only, with its packed input kernel
bool fact_ok(int form, int fact, int res_f, const void* f_w) {
  return fact ? form == FORM_Q8 && f_w != nullptr : !res_f;
}

}  // namespace

// The most clusters of `cluster` blocks with `smem` bytes each that the card
// holds at once for form `form` (0 f32, 1 bf16, 2 q8), nt stream tiles
// (S = 8 nt) and kind (0 masked, 1 free-running, 2 teacher-forced); a
// negative CUDA error code on failure. The factored q8 kernels of a shape
// have the same threads, shared memory and register bound as the composed
// ones that answer here.
extern "C" int lpcnet_masked_loop_max_clusters(int form, int nt, int kind, int cluster,
                                               int smem) {
  const K2Kernel k = kernel_for(form, nt, kind, 0);
  if (!k) return -(int)cudaErrorInvalidValue;
  cudaError_t e = k2_attributes(k, cluster, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = k2_config(cluster * 64, cluster, smem, 0, &attr);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, k, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

// K2. a_w: the packed GRU-A slices (bf16 / q8 [C][3U/16][ceil(Na/KS)][32][16
// bytes], f32 [C][ceil(Na/4)][3U][4]); b_w: bf16 / q8 packed GRU-B weights
// (null in f32); b_in [Na, 3Nb], b_rec [Nb, 3Nb]: f32 only; cluster: C of
// masked_loop.py::cluster_shape (up to 8, in f32 up to 16); res_a, res_b:
// keep the packed weights in shared memory (res_b: not in f32); smem: the
// layout's total (masked_loop.py::masked_smem_bytes); emb [768, 3Na],
// emb_scale and a_diag [3Na] (q8), a_bias1 [3Na], b_bias1 [3Nb], the
// sampler's dual_w [Nb, 512], dual_bias, dual_factor [512], logit_table
// [256], cond_a [B, 3Na], cond_b [B, 3Nb], lpc [B, 16] and the carried state
// (h_a, h_b, last_sig [B, 16], last_exc int32, deemph, the KISS99 words [B,
// 4] int64) in and out, pcm [B, n] f32; preload [B, n] f32, mode [B, n]
// int32 (advance | teacher_force << 1). With free_ (K1: the free-running
// form) preload and mode are not read and may be null, and sampled must be
// 1.
extern "C" int lpcnet_masked_loop(
    int form, int nt, int free_, int cluster, int smem, int res_a, int res_b, int fact, int res_f,
    int batch, int na, int nb,
    int n_samples, int sampled, const void* emb, const void* emb_scale, const void* a_w,
    const void* a_diag, const void* a_bias1, const void* b_w, const void* b_in,
    const void* b_rec, const void* b_bias1, const void* f_w, const void* dual_w,
    const void* dual_bias,
    const void* dual_factor, const void* logit_table, const void* cond_a, const void* cond_b,
    const void* lpc, const void* ha_in, const void* hb_in, const void* sig_in,
    const void* exc_in, const void* de_in, const void* rng_in, void* ha_out, void* hb_out,
    void* sig_out, void* exc_out, void* de_out, void* rng_out, void* pcm, const void* preload,
    const void* mode, void* stream) {
  const int kind = free_ ? KIND_FREE : KIND_MASKED;
  const K2Kernel k = kernel_for(form, nt, kind, fact);
  if (!k || batch <= 0 || n_samples <= 0 || (!free_ && (!preload || !mode)) || cluster < 1 ||
      cluster > (form == FORM_F32 ? 16 : 8) || na <= 0 || nb <= 0 ||
      (form == FORM_F32 && res_b) ||
      (free_ && (!sampled || (8 * nt + cluster - 1) / cluster > 8)) ||
      !fact_ok(form, fact, res_f, f_w))
    return (int)cudaErrorInvalidValue;
  if ((size_t)smem != k2_layout(form, na, nb, cluster, 8 * nt, res_a, res_b, kind, 0, fact,
                                res_f).total)
    return (int)cudaErrorInvalidValue;
  K2Args a = {};
  a.batch = batch; a.na = na; a.nb = nb; a.n_samples = n_samples; a.sampled = sampled;
  a.cluster = cluster; a.res_a = res_a; a.res_b = res_b; a.res_f = res_f;
  a.emb = emb; a.emb_scale = (const float*)emb_scale;
  a.a_w = a_w; a.a_diag = (const float*)a_diag; a.a_bias1 = (const float*)a_bias1;
  a.b_w = b_w; a.b_in = (const float*)b_in; a.b_rec = (const float*)b_rec;
  a.b_bias1 = (const float*)b_bias1; a.f_w = f_w;
  a.dual_w = (const float*)dual_w; a.dual_bias = (const float*)dual_bias;
  a.dual_factor = (const float*)dual_factor; a.logit_table = (const float*)logit_table;
  a.cond_a = (const float*)cond_a; a.cond_b = (const float*)cond_b; a.lpc = (const float*)lpc;
  a.ha_in = (const float*)ha_in; a.hb_in = (const float*)hb_in; a.sig_in = (const float*)sig_in;
  a.exc_in = (const int*)exc_in; a.de_in = (const float*)de_in;
  a.rng_in = (const long long*)rng_in;
  a.ha_out = (float*)ha_out; a.hb_out = (float*)hb_out; a.sig_out = (float*)sig_out;
  a.exc_out = (int*)exc_out; a.de_out = (float*)de_out; a.rng_out = (long long*)rng_out;
  a.pcm = (float*)pcm; a.preload = (const float*)preload; a.mode = (const int*)mode;
  return k2_launch(k, a, nt, smem, stream);
}

// K3, the teacher-forced form. a_w, b_w, b_in, b_rec, res_a, res_b, smem as
// K2's (smem: masked_loop.py::masked_smem_bytes with tf_blocks = n_blocks);
// cond_a [B, n_blocks, 3Na], cond_b [B, n_blocks, 3Nb] f32; counts
// [B, n_blocks] int32 (clamped to 0..blk_samples); codes
// [B, n_blocks * blk_samples, 3] uint8; h_a, h_b and the KISS99 words
// ([B, 4] int64) in and out.
extern "C" int lpcnet_teacher_force(
    int form, int nt, int cluster, int smem, int res_a, int res_b, int fact, int res_f, int batch,
    int na, int nb, int n_blocks, int blk_samples, const void* emb, const void* emb_scale,
    const void* a_w, const void* a_diag, const void* a_bias1, const void* b_w, const void* b_in,
    const void* b_rec, const void* b_bias1, const void* f_w, const void* cond_a, const void* cond_b,
    const void* counts, const void* codes, const void* ha_in, const void* hb_in,
    const void* rng_in, void* ha_out, void* hb_out, void* rng_out, void* stream) {
  const K2Kernel k = kernel_for(form, nt, KIND_TF, fact);
  if (!k || batch <= 0 || n_blocks <= 0 || blk_samples <= 0 || cluster < 1 ||
      cluster > (form == FORM_F32 ? 16 : 8) || na <= 0 || nb <= 0 ||
      (form == FORM_F32 && res_b) ||
      (8 * nt + cluster - 1) / cluster > 8 || !fact_ok(form, fact, res_f, f_w))
    return (int)cudaErrorInvalidValue;
  if ((size_t)smem != k2_layout(form, na, nb, cluster, 8 * nt, res_a, res_b, KIND_TF,
                                n_blocks, fact, res_f).total)
    return (int)cudaErrorInvalidValue;
  K2Args a = {};
  a.batch = batch; a.na = na; a.nb = nb; a.cluster = cluster; a.res_a = res_a; a.res_b = res_b;
  a.res_f = res_f; a.f_w = f_w;
  a.n_blocks = n_blocks; a.blk = blk_samples;
  a.counts = (const int*)counts; a.codes = (const uint8_t*)codes;
  a.emb = emb; a.emb_scale = (const float*)emb_scale;
  a.a_w = a_w; a.a_diag = (const float*)a_diag; a.a_bias1 = (const float*)a_bias1;
  a.b_w = b_w; a.b_in = (const float*)b_in; a.b_rec = (const float*)b_rec;
  a.b_bias1 = (const float*)b_bias1;
  a.cond_a = (const float*)cond_a; a.cond_b = (const float*)cond_b;
  a.ha_in = (const float*)ha_in; a.hb_in = (const float*)hb_in;
  a.rng_in = (const long long*)rng_in;
  a.ha_out = (float*)ha_out; a.hb_out = (float*)hb_out; a.rng_out = (long long*)rng_out;
  return k2_launch(k, a, nt, smem, stream);
}
