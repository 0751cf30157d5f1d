// DRED's redundancy payloads framed on the card, one thread a stream.
//
// Replaces no TPU kernel: the JAX package frames its payloads on the host
// (lpcnet_tpu/dred/entropy.py), as the port's native runtime does
// (runtime/native/lpcnet_runtime.cc::dred_frame_payloads). It was added
// because that host call codes 1024 streams' payloads one after another on
// one core, while the card, drained by the readback, waits. Each stream's
// bytes are the native call's, byte for byte: the 3-byte header, the
// enumerative PVQ index of the pulses in 128-bit arithmetic, big-endian in
// nsb bytes, then the binary range coder over the L x D symbols (the zero
// flag at p0, the sign at 1/2, the magnitude's continue flags at
// 32768 - r, MAX_MAG's clamp, the backward carry and the trailing-zero
// codeword). The arithmetic is integer only.
//
// What bounds it on an H100: the chain of dependent binary decisions of
// the longest stream (~2,080-4,000 at the served traffic, each one a
// 32x32-bit product, clamps and a renormalisation on the coder's state).
// The 1024 streams are independent and the bytes (a few MB) are no
// bound.
//
// What this design does about it:
// * One thread a stream, and each thread a block, so a warp, of its own:
//   1024 streams are 1024 warps, ~8 an SM and two to a scheduler, whose
//   chains interleave. The lanes of one warp would each take their own
//   stream's branches (a zero or not, how many continue flags) and the
//   warp would run every lane's: measured on an H100 (with a form of this
//   loop that made one decision an iteration), 32 streams to a warp took
//   2.9 times one stream's time.
// * The loop over a stream's symbols is the native coder's, with symbol
//   i + 1 and its p0 loaded while i is coded.
// * The coder never reads back what it wrote: a byte that may still take
//   a carry is held in registers until it cannot (`Coder`).
// * Each stream codes into its own slot of `stride` bytes and writes its
//   length, counting past the slot's end as the native coder counts past
//   its cap; the wrapper relaunches at a larger stride where a length
//   passes it. A second kernel packs the slots back to back from the
//   lengths' exclusive sum, so the host copies the payloads' bytes only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned __int128 u128;

#define PACK_THREADS 128  // threads a block (a stream) of the packer

constexpr uint32_t kTopByte = 1u << 24;
constexpr int kMaxMag = 255;

// The native coder's bytes with no read of memory: a renormalisation's
// byte is held back while it may still take a carry (the last byte below
// 0xFF and the run of 0xFF bytes after it: `cache`, `nff`), as LZMA's coder
// holds them, and `low` keeps the carry in its bit 32 until then. The
// native coder writes each byte at once and walks back through the bytes
// it wrote on a carry, which on the card is a read from L2 every few
// decisions. Bytes at or past `cap` are counted, not written.
struct Coder {
  uint8_t* out;
  int64_t pos, cap, nff, zeros;  // bytes out, room, 0xFF bytes held, trailing zeros out
  uint64_t low;                  // 32 bits and a carry
  uint32_t range;
  int cache;                     // the byte held before the 0xFF run; -1: none yet
};

__device__ __forceinline__ void put(Coder& c, uint32_t byte) {
  if (c.pos < c.cap) c.out[c.pos] = (uint8_t)byte;
  c.pos++;
  c.zeros = byte ? 0 : c.zeros + 1;
}

// the top byte of low out (held back), the carry into the held bytes
__device__ __forceinline__ void shift(Coder& c) {
  const uint32_t low32 = (uint32_t)c.low;
  if (low32 < 0xFF000000u || (c.low >> 32)) {
    const uint32_t cy = (uint32_t)(c.low >> 32);
    if (c.cache >= 0) put(c, (c.cache + cy) & 0xFF);
    for (; c.nff > 0; c.nff--) put(c, (0xFF + cy) & 0xFF);
    c.cache = (int)(low32 >> 24);
  } else {
    c.nff++;
  }
  c.low = (uint32_t)(low32 << 8);
}

__device__ __forceinline__ void encode_bit(Coder& c, int bit, uint32_t p0_q15) {
  uint32_t split = (uint32_t)(((uint64_t)c.range * p0_q15) >> 15);
  if (split < 1) split = 1;
  if (split > c.range - 1) split = c.range - 1;
  if (bit) {
    c.low += split;
    c.range -= split;
  } else {
    c.range = split;
  }
  while (c.range < kTopByte) {
    c.range <<= 8;
    shift(c);
  }
}

// the codeword in [low, low + range) with the most trailing zero bytes,
// its trailing zeros dropped; a result past cap tells of overflow
__device__ int64_t finish(Coder& c) {
  const uint32_t low32 = (uint32_t)c.low;
  for (int m = 4; m >= 0; m--) {
    const uint64_t step = 1ull << (8 * m);
    const uint64_t w = ((uint64_t)low32 + step - 1) / step * step;
    if (w < (uint64_t)low32 + c.range) {
      c.low = c.low - low32 + w;
      break;
    }
  }
  for (int i = 0; i < 4; i++) shift(c);
  if (c.cache >= 0) put(c, (uint32_t)c.cache);
  for (; c.nff > 0; c.nff--) put(c, 0xFF);
  if (c.pos <= c.cap) c.pos -= c.zeros;
  return c.pos;
}

__device__ __forceinline__ uint32_t clamp_q15(int32_t p) {
  return (uint32_t)(p < 1 ? 1 : (p > 32767 ? 32767 : p));
}

struct FrameArgs {
  const int16_t* sym;    // [batch][row]: the n_sym symbols, then the pulses
  const int32_t* probs;  // [2][n_sym]: p0 then r, Q15 (clamped here)
  const u128* vtab;      // [state_dim + 1][state_k + 1]: V(n, k)
  uint8_t* slots;        // [batch][stride]
  int32_t* lengths;      // [batch]: bytes, past stride on overflow; -2 bad pulses
  int64_t stride;
  int batch, row, n_sym, state_dim, state_k, nsb;
  uint8_t head0, head1, head2;
};

__global__ void __launch_bounds__(1) frame_kernel(const FrameArgs a) {
  const int b = blockIdx.x;
  const int16_t* z = a.sym + (int64_t)b * a.row;
  const int16_t* y = z + a.n_sym;
  int total = 0;
  for (int j = 0; j < a.state_dim; j++) total += y[j] < 0 ? -y[j] : y[j];
  if (total != a.state_k) {
    a.lengths[b] = -2;
    return;
  }
  // the enumerative index: per position, magnitude 0 first, then +1, -1,
  // +2, -2, ... (dred/entropy.py::pvq_encode_index)
  const int kk = a.state_k + 1;
  u128 idx = 0;
  int k = a.state_k;
  for (int j = 0; j < a.state_dim; j++) {
    const int v = y[j], m = v < 0 ? -v : v;
    const u128* vr = a.vtab + (int64_t)(a.state_dim - j - 1) * kk;
    if (m != 0) {
      idx += vr[k];
      for (int i = 1; i < m; i++) idx += 2 * vr[k - i];
      if (v < 0) idx += vr[k - m];
    }
    k -= m;
  }
  uint8_t* o = a.slots + (int64_t)b * a.stride;
  const int head = 3 + a.nsb;
  o[0] = a.head0;
  o[1] = a.head1;
  o[2] = a.head2;
  for (int i = 0; i < a.nsb; i++) o[3 + i] = (uint8_t)(idx >> (8 * (a.nsb - 1 - i)));

  Coder c{o + head, 0, a.stride - head, 0, 0, 0, 0xFFFFFFFFu, -1};
  const int32_t* p0 = a.probs;
  const int32_t* r = a.probs + a.n_sym;
  // a symbol's zero flag at p0; a nonzero one's sign at 1/2, then its
  // magnitude's continue flags at 32768 - r (MAX_MAG has no stop flag).
  // Symbol i + 1 and its p0 are loaded while i is coded.
  const int n = a.n_sym;
  int zn = z[0];
  int32_t pn = __ldg(p0);
  for (int i = 0; i < n; i++) {
    const int zi = zn;
    const uint32_t pz = clamp_q15(pn);
    if (i + 1 < n) {
      zn = z[i + 1];
      pn = __ldg(p0 + i + 1);
    }
    encode_bit(c, zi != 0, pz);
    if (zi == 0) continue;
    encode_bit(c, zi < 0, 1u << 14);
    const int mag = min(zi < 0 ? -zi : zi, kMaxMag);
    const uint32_t pc = 32768u - clamp_q15(__ldg(r + i));
    for (int m = 1; m < mag; m++) encode_bit(c, 1, pc);
    if (mag < kMaxMag) encode_bit(c, 0, pc);
  }
  const int64_t len = head + finish(c);
  a.lengths[b] = (int32_t)(len < 0x7FFFFFFF ? len : 0x7FFFFFFF);
}

__device__ __forceinline__ int64_t slot_bytes(int32_t len, int64_t stride) {
  return len < 0 ? 0 : (len > stride ? stride : len);
}

// block b: the sum of the earlier streams' lengths, then stream b's bytes
// copied there; lengths past the stride or negative are clamped (the host
// relaunches or raises on them and reads none of these bytes)
__global__ void __launch_bounds__(PACK_THREADS) pack_kernel(
    const uint8_t* slots, const int32_t* lengths, int64_t stride, uint8_t* packed) {
  __shared__ long long part[PACK_THREADS / 32];
  const int b = blockIdx.x;
  long long s = 0;
  for (int i = threadIdx.x; i < b; i += PACK_THREADS) s += slot_bytes(lengths[i], stride);
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xFFFFFFFFu, s, d);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  long long off = 0;
  for (int w = 0; w < PACK_THREADS / 32; w++) off += part[w];
  const int64_t n = slot_bytes(lengths[b], stride);
  const uint8_t* src = slots + (int64_t)b * stride;
  for (int64_t t = threadIdx.x; t < n; t += PACK_THREADS) packed[off + t] = src[t];
}

}  // namespace

// Every stream's payload: sym [batch][n_sym + state_dim] int16 (the
// symbols of n_latents x latent_dim, then the pulses), probs [2][n_sym]
// int32 (p0, r Q15), vtab [state_dim + 1][state_k + 1] of 128-bit V(n, k)
// (16-byte aligned), slots and packed [batch * stride] bytes, lengths
// [batch] int32; nsb: the PVQ index's bytes. Launches the coder, then the
// packer, on `stream`. Returns 0 or a CUDA error.
extern "C" int lpcnet_dred_frame(const void* sym, const void* probs, const void* vtab,
                                 void* slots, void* lengths, void* packed, int batch,
                                 int n_latents, int latent_dim, int state_dim, int state_k,
                                 int nsb, int q0, int q1, long long stride, void* stream) {
  if (batch < 1 || n_latents < 1 || n_latents >= 4096 || latent_dim < 1 || state_dim < 1 ||
      state_k < 0 || nsb < 1 || nsb > 16 || q0 < 0 || q0 > 15 || q1 < 0 || q1 > 15 ||
      stride < 3 + nsb || stride > 0x40000000LL || ((uintptr_t)vtab & 15))
    return (int)cudaErrorInvalidValue;
  FrameArgs a;
  a.sym = (const int16_t*)sym;
  a.probs = (const int32_t*)probs;
  a.vtab = (const u128*)vtab;
  a.slots = (uint8_t*)slots;
  a.lengths = (int32_t*)lengths;
  a.stride = stride;
  a.batch = batch;
  a.n_sym = n_latents * latent_dim;
  a.row = a.n_sym + state_dim;
  a.state_dim = state_dim;
  a.state_k = state_k;
  a.nsb = nsb;
  a.head0 = (uint8_t)((1 << 4) | q0);
  a.head1 = (uint8_t)((q1 << 4) | (n_latents >> 8));
  a.head2 = (uint8_t)(n_latents & 0xFF);
  cudaStream_t s = (cudaStream_t)stream;
  frame_kernel<<<batch, 1, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pack_kernel<<<batch, PACK_THREADS, 0, s>>>((const uint8_t*)slots, (const int32_t*)lengths,
                                             stride, (uint8_t*)packed);
  return (int)cudaGetLastError();
}
