// DRED's redundancy payloads parsed on the card, one thread a stream.
//
// Replaces no TPU kernel: the JAX package parses its payloads on the host
// (lpcnet_tpu/dred/entropy.py::decode_payload), as the port's native
// runtime does (runtime/native/lpcnet_runtime.cc::dred_parse_payloads). It
// was added because that host call parses 1024 streams' payloads one after
// another on one core, ~20 ms a decoding tick, while the card waits, and
// then the rows cross PCIe. It is the inverse of csrc/dred_payload.cu (D1)
// over the same tables, and each stream's row is the native call's, value
// for value: the header's q0, q1; the enumerative PVQ index read big-endian
// from its nsb bytes and walked into the pulses over V(n, k) in 128-bit
// arithmetic; the latents' levels from q1 (oldest) to q0 (newest), rounded
// in double to even as the native call rounds; then the binary range
// decoder over the L x D symbols (the zero flag at p0, the sign at 1/2,
// the magnitude's continue flags at 32768 - r up to MAX_MAG). The host
// checks every payload before the launch (kernels/dred_parse.py), so the
// kernel meets no payload that the native call refuses.
//
// What bounds it on an H100: the chain of dependent binary decisions of
// the longest stream (~2,900-3,100 at the served traffic, each a 32x32-bit
// product, two clamps, a compare and a renormalisation test on the
// decoder's state), ~0.04 ms at ~24 cycles a decision and 1.98 GHz. The
// streams are independent, and the bytes (~0.4 MB in, ~4.4 MB of rows
// out) are no bound.
//
// What this design does about it:
// * One thread a stream, and so one warp: a warp's lanes would each take
//   their own stream's branches (a zero or not, how many continue flags),
//   and the warp would run every lane's (D1 measured 2.9x one stream's
//   time for 32 streams to a warp). WARPS streams share a block, whose
//   threads first copy the tables into shared memory together: V(n, k)
//   (25 x 83 x 16 B at the served widths) and the clamped p0 and stop
//   probabilities of every level (2 x 16 x 80 x 2 B). 1024 streams are
//   128 blocks, about one an SM, two warps to a scheduler, whose chains
//   interleave.
// * The decoder reads each byte it shifts in one renormalisation ahead,
//   so the load from L1 or L2 overlaps the decisions between two.
// * A latent's p0 row is chosen once, and symbol i + 1's p0 and stop
//   probability are read while i is decoded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned __int128 u128;

#define WARPS 8  // streams (warps) a block

constexpr uint32_t kTopByte = 1u << 24;
constexpr int kMaxMag = 255;

// The native decoder (rd_init, rd_decode_bit): diff = code - low, always
// below range, so 32 bits hold it; bytes past the payload read as zero.
// `next` is the byte the next renormalisation shifts in, read ahead.
struct Decoder {
  const uint8_t* data;
  int64_t len, pos;
  uint32_t diff, range, next;
};

__device__ __forceinline__ uint32_t byte_at(const Decoder& d, int64_t i) {
  return i < d.len ? (uint32_t)__ldg(d.data + i) : 0u;
}

__device__ __forceinline__ int decode_bit(Decoder& d, uint32_t p0_q15) {
  uint32_t split = (uint32_t)(((uint64_t)d.range * p0_q15) >> 15);
  if (split < 1) split = 1;
  if (split > d.range - 1) split = d.range - 1;
  int bit;
  if (d.diff < split) {
    bit = 0;
    d.range = split;
  } else {
    bit = 1;
    d.diff -= split;
    d.range -= split;
  }
  while (d.range < kTopByte) {
    d.diff = (d.diff << 8) | d.next;
    d.range <<= 8;
    d.pos++;
    d.next = byte_at(d, d.pos);
  }
  return bit;
}

struct ParseArgs {
  const int64_t* starts;  // [batch + 1]: payload b is bytes [starts[b], starts[b + 1])
  const uint8_t* data;    // the payloads back to back
  const u128* vtab;       // [state_dim + 1][state_k + 1]: V(n, k)
  const uint16_t* probs;  // [2][levels][dim]: p0 clamped to [1, 32767], then 32768 - r clamped
  int16_t* rows;          // [batch][n_sym + state_dim + n_lat]
  int batch, n_lat, dim, state_dim, state_k, nsb, levels, n_vtab;
};

__global__ void __launch_bounds__(WARPS * 32) parse_kernel(const ParseArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  u128* vtab = reinterpret_cast<u128*>(smem);
  uint16_t* probs = reinterpret_cast<uint16_t*>(smem + 16 * (int64_t)a.n_vtab);
  const int n_probs = 2 * a.levels * a.dim;
  for (int i = threadIdx.x; i < a.n_vtab; i += blockDim.x) vtab[i] = a.vtab[i];
  for (int i = threadIdx.x; i < n_probs; i += blockDim.x) probs[i] = a.probs[i];
  __syncthreads();
  const int b = blockIdx.x * WARPS + threadIdx.x / 32;
  if (threadIdx.x % 32 != 0 || b >= a.batch) return;

  const uint8_t* p = a.data + a.starts[b];
  const int64_t len = a.starts[b + 1] - a.starts[b];
  const int q0 = p[0] & 0xF, q1 = p[1] >> 4;
  const int n_sym = a.n_lat * a.dim;
  int16_t* o = a.rows + (int64_t)b * (n_sym + a.state_dim + a.n_lat);

  // pulses (dred/entropy.py::pvq_decode_index): per position the zero
  // block, then +1, -1, +2, -2, ...
  u128 idx = 0;
  for (int i = 0; i < a.nsb; i++) idx = idx << 8 | p[3 + i];
  const int kk = a.state_k + 1;
  int16_t* y = o + n_sym;
  int k = a.state_k;
  for (int j = 0; j < a.state_dim; j++) {
    const u128* vr = vtab + (a.state_dim - j - 1) * kk;
    int val = 0;
    if (idx >= vr[k]) {
      idx -= vr[k];
      for (int m = 1; m <= k; m++) {
        const u128 block = vr[k - m];
        if (idx < block) {
          val = m;
          break;
        }
        idx -= block;
        if (idx < block) {
          val = -m;
          break;
        }
        idx -= block;
      }
    }
    y[j] = (int16_t)val;
    k -= val < 0 ? -val : val;
  }

  // the latents, oldest first, each at its level
  const int head = 3 + a.nsb;
  Decoder d{p + head, len - head, 4, 0, 0xFFFFFFFFu, 0};
  for (int i = 0; i < 4; i++) d.diff = (d.diff << 8) | byte_at(d, i);
  d.next = byte_at(d, 4);
  const uint16_t* p0_tab = probs;
  const uint16_t* stop_tab = probs + a.levels * a.dim;
  int16_t* lv = o + n_sym + a.state_dim;
  int16_t* z = o;
  for (int l = 0; l < a.n_lat; l++) {
    const int q = a.n_lat == 1 ? q0 : (int)rint((double)q1 + (double)((q0 - q1) * l)
                                                                / (double)(a.n_lat - 1));
    lv[l] = (int16_t)q;
    const uint16_t* p0r = p0_tab + q * a.dim;
    const uint16_t* sr = stop_tab + q * a.dim;
    uint32_t pn = p0r[0], sn = sr[0];
    for (int i = 0; i < a.dim; i++) {
      const uint32_t pz = pn, ps = sn;
      if (i + 1 < a.dim) {
        pn = p0r[i + 1];
        sn = sr[i + 1];
      }
      if (decode_bit(d, pz) == 0) {
        z[i] = 0;
        continue;
      }
      const int neg = decode_bit(d, 1u << 14);
      int mag = 1;
      while (mag < kMaxMag && decode_bit(d, ps) == 1) mag++;
      z[i] = (int16_t)(neg ? -mag : mag);
    }
    z += a.dim;
  }
}

}  // namespace

// Every stream's row: stage holds int64 starts [batch + 1] (starts[0] = 0,
// the last the payloads' total bytes), then the payloads back to back;
// vtab [state_dim + 1][state_k + 1] of 128-bit V(n, k) (16-byte aligned);
// probs [2][levels][latent_dim] uint16 (p0 clamped to [1, 32767], then
// 32768 - r clamped); rows [batch][L * D + S + L] int16. nsb: the PVQ
// index's bytes. Every payload must have passed the host's checks
// (kernels/dred_parse.py::refusal). Launches the parser on `stream`.
// Returns 0 or a CUDA error.
extern "C" int lpcnet_dred_parse(const void* stage, const void* vtab, const void* probs,
                                 void* rows, int batch, int n_latents, int latent_dim,
                                 int state_dim, int state_k, int nsb, int levels,
                                 void* stream) {
  if (batch < 1 || n_latents < 1 || n_latents >= 4096 || latent_dim < 1 || state_dim < 1 ||
      state_k < 0 || nsb < 1 || nsb > 16 || levels < 1 || levels > 16 ||
      ((uintptr_t)vtab & 15) || ((uintptr_t)stage & 7) || ((uintptr_t)probs & 1) ||
      ((uintptr_t)rows & 1))
    return (int)cudaErrorInvalidValue;
  ParseArgs a;
  a.starts = (const int64_t*)stage;
  a.data = (const uint8_t*)stage + 8 * ((int64_t)batch + 1);
  a.vtab = (const u128*)vtab;
  a.probs = (const uint16_t*)probs;
  a.rows = (int16_t*)rows;
  a.batch = batch;
  a.n_lat = n_latents;
  a.dim = latent_dim;
  a.state_dim = state_dim;
  a.state_k = state_k;
  a.nsb = nsb;
  a.levels = levels;
  a.n_vtab = (state_dim + 1) * (state_k + 1);
  const size_t smem = 16 * (size_t)a.n_vtab + 4 * (size_t)levels * latent_dim;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (batch + WARPS - 1) / WARPS;
  parse_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
