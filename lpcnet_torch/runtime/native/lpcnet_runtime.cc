// Native host runtime for lpcnet_torch: the host-side pieces around the
// CUDA compute path that are sequential by nature.
//
//   * 64-bit codec packet bit packing/unpacking (cf. src/lpcnet_enc.c:443-463)
//   * u-law companding with the reference's log2 approximation
//     (cf. src/common.h:18-58)
//   * KISS99 PRNG (cf. src/kiss99.c:32-81)
//   * the sequential parts of training-data generation: time-varying biquads
//     and the noisy-excitation teacher loop (cf. src/dump_data.c:46-56,84-108)
//   * a multi-stream batching assembler for serving (gather per-stream
//     frames into device-batch order and scatter results back)
//   * DRED's latent range coder, byte-compatible with dred/entropy.py, the
//     framing of a whole batch of DRED payloads in one call and its inverse,
//     the parse of a whole batch
//
// Built by runtime/bindings.py with g++ -O3 -shared -fPIC into
// lpcnet_torch/runtime/build/ at first use, loaded with ctypes. The same
// source as the JAX package's host runtime, so both write the same bytes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// u-law
// ---------------------------------------------------------------------------

static const float kLog256 = 5.5451774445f;

static inline float log2_approx(float x) {
  union { float f; int32_t i; } in;
  in.f = x;
  int integer = (in.i >> 23) - 127;
  in.i -= integer << 23;
  float frac = in.f - 1.5f;
  frac = -0.41445418f + frac * (0.95909232f
         + frac * (-0.33951290f + frac * 0.16541097f));
  return 1.f + integer + frac;
}

int lin2ulaw(float x) {
  float scale = 255.f / 32768.f;
  int s = x >= 0 ? 1 : -1;
  x = std::fabs(x);
  float u = s * (128.f * 0.69315f * log2_approx(1.f + scale * x) / kLog256);
  u = 128.f + u;
  u = std::min(255.f, std::max(0.f, u));
  return (int)std::floor(.5f + u);
}

float ulaw2lin(float u) {
  float scale_1 = 32768.f / 255.f;
  u = u - 128.f;
  float s = u >= 0 ? 1.f : -1.f;
  u = std::fabs(u);
  return s * scale_1 * (std::exp(u / 128.f * kLog256) - 1.f);
}

void lin2ulaw_batch(const float* x, int32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) out[i] = lin2ulaw(x[i]);
}

void ulaw2lin_batch(const int32_t* u, float* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) out[i] = ulaw2lin((float)u[i]);
}

// ---------------------------------------------------------------------------
// KISS99
// ---------------------------------------------------------------------------

typedef struct { uint32_t z, w, jsr, jcong; } kiss99_state;

void kiss99_seed(kiss99_state* st, const uint8_t* data, int n) {
  st->z = 362436069u; st->w = 521288629u;
  st->jsr = 123456789u; st->jcong = 380116160u;
  int i;
  for (i = 3; i < n; i += 4) {
    st->z ^= data[i - 3]; st->w ^= data[i - 2];
    st->jsr ^= data[i - 1]; st->jcong ^= data[i];
    // advance once
    uint32_t znew = 36969u * (st->z & 0xFFFFu) + (st->z >> 16);
    uint32_t wnew = 18000u * (st->w & 0xFFFFu) + (st->w >> 16);
    uint32_t shr3 = st->jsr ^ (st->jsr << 13);
    shr3 ^= shr3 >> 17; shr3 ^= shr3 << 5;
    st->z = znew; st->w = wnew; st->jsr = shr3;
    st->jcong = 69069u * st->jcong + 1234567u;
  }
  if (i - 3 < n) st->z ^= data[i - 3];
  if (i - 2 < n) st->w ^= data[i - 2];
  if (i - 1 < n) st->jsr ^= data[i - 1];
  if (st->z == 0 || st->z == 0x9068FFFFu) st->z++;
  if (st->w == 0 || st->w == 0x464FFFFFu) st->w++;
  if (st->jsr == 0) st->jsr++;
}

uint32_t kiss99_next(kiss99_state* st) {
  uint32_t znew = 36969u * (st->z & 0xFFFFu) + (st->z >> 16);
  uint32_t wnew = 18000u * (st->w & 0xFFFFu) + (st->w >> 16);
  uint32_t mwc = (znew << 16) + wnew;
  uint32_t shr3 = st->jsr ^ (st->jsr << 13);
  shr3 ^= shr3 >> 17; shr3 ^= shr3 << 5;
  uint32_t cong = 69069u * st->jcong + 1234567u;
  st->z = znew; st->w = wnew; st->jsr = shr3; st->jcong = cong;
  return (mwc ^ cong) + shr3;
}

// ---------------------------------------------------------------------------
// Codec packet bit I/O (field widths: 7,6,3,2,10,10,10,13,3 = 64 bits)
// ---------------------------------------------------------------------------

static const int kFieldBits[9] = {7, 6, 3, 2, 10, 10, 10, 13, 3};

void pack_packets(const int32_t* fields, uint8_t* out, int64_t n_packets) {
  for (int64_t p = 0; p < n_packets; p++) {
    uint64_t word = 0;
    for (int f = 0; f < 9; f++) {
      int bits = kFieldBits[f];
      uint64_t v = (uint64_t)(fields[p * 9 + f]) & ((1ull << bits) - 1);
      word = (word << bits) | v;
    }
    for (int i = 0; i < 8; i++)
      out[p * 8 + i] = (uint8_t)(word >> (8 * (7 - i)));
  }
}

void unpack_packets(const uint8_t* in, int32_t* fields, int64_t n_packets) {
  for (int64_t p = 0; p < n_packets; p++) {
    uint64_t word = 0;
    for (int i = 0; i < 8; i++) word = (word << 8) | in[p * 8 + i];
    int pos = 64;
    for (int f = 0; f < 9; f++) {
      pos -= kFieldBits[f];
      fields[p * 9 + f] = (int32_t)((word >> pos) & ((1ull << kFieldBits[f]) - 1));
    }
  }
}

// ---------------------------------------------------------------------------
// Training data generation (sequential pieces of dump_data)
// ---------------------------------------------------------------------------

// Time-invariant biquad with carried state (src/dump_data.c:46-56).
void biquad(float* y, float* mem, const float* x, const float* b,
            const float* a, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    float xi = x[i];
    float yi = x[i] + mem[0];
    mem[0] = mem[1] + (b[0] * (double)xi - a[0] * (double)yi);
    mem[1] = (b[1] * (double)xi - a[1] * (double)yi);
    y[i] = yi;
  }
}

static inline int16_t float2short(float x) {
  int i = (int)std::floor(.5 + x);
  return (int16_t)std::max(-32767, std::min(32767, i));
}

// Noisy-excitation teacher loop (write_audio, src/dump_data.c:84-108):
// produces interleaved (sig_in, sig_out) training pairs while corrupting the
// fed-back signal with u-law-domain noise on the excitation.
//
//   pcm:    [n_frames*160] clean target samples (float)
//   lpc:    [n_frames*16]  per-frame LPC
//   noise:  [n_frames*160] integer u-law-domain noise
//   sig_mem:[16] carried AR memory, exc_mem: carried (unused, kept for ABI)
//   out:    [n_frames*160*2] int16 interleaved pairs
void write_audio_frames(const float* pcm, const float* lpc,
                        const int32_t* noise, float* sig_mem,
                        int32_t* exc_mem, int16_t* out,
                        int64_t n_frames) {
  const int F = 160, ORDER = 16;
  for (int64_t k = 0; k < n_frames; k++) {
    const float* L = lpc + k * ORDER;
    for (int i = 0; i < F; i++) {
      float p = 0;
      for (int j = 0; j < ORDER; j++) p -= L[j] * sig_mem[j];
      float target = pcm[k * F + i];
      int e = lin2ulaw(target - p);
      out[2 * (k * F + i)] = float2short(sig_mem[0]);
      out[2 * (k * F + i) + 1] = float2short(target);
      e += noise[k * F + i];
      e = std::min(255, std::max(0, e));
      std::memmove(sig_mem + 1, sig_mem, (ORDER - 1) * sizeof(float));
      sig_mem[0] = p + ulaw2lin((float)e);
      *exc_mem = e;
    }
  }
}

// Laplace-ish u-law noise (compute_noise, src/dump_data.c:69-74).
void compute_noise_frames(int32_t* noise, const float* noise_std,
                          int64_t n_frames, uint64_t seed) {
  kiss99_state st;
  uint8_t sd[8];
  std::memcpy(sd, &seed, 8);
  kiss99_seed(&st, sd, 8);
  const int F = 160;
  for (int64_t k = 0; k < n_frames; k++) {
    for (int i = 0; i < F; i++) {
      float u1 = (kiss99_next(&st) + 0.5f) / 4294967296.f;
      float u2 = (kiss99_next(&st) + 0.5f) / 4294967296.f;
      noise[k * F + i] = (int)std::floor(
          .5 + noise_std[k] * .707f * (std::log(u1) - std::log(u2)));
    }
  }
}

// ---------------------------------------------------------------------------
// Multi-stream batching assembler for serving
// ---------------------------------------------------------------------------

// Gather per-stream frames (stream-major ragged input described by offsets)
// into a dense [batch, frame] matrix in slot order; inverse scatter for
// synthesized PCM. These run on the host thread that feeds the device step.
void gather_frames(const float* src, const int64_t* offsets,
                   const int32_t* slots, float* dst,
                   int64_t n_active, int64_t frame_len) {
  for (int64_t s = 0; s < n_active; s++) {
    std::memcpy(dst + (int64_t)slots[s] * frame_len,
                src + offsets[s], frame_len * sizeof(float));
  }
}

void scatter_frames(const float* src, const int32_t* slots,
                    int16_t* dst, const int64_t* offsets,
                    int64_t n_active, int64_t frame_len) {
  for (int64_t s = 0; s < n_active; s++) {
    const float* row = src + (int64_t)slots[s] * frame_len;
    int16_t* o = dst + offsets[s];
    for (int64_t i = 0; i < frame_len; i++) o[i] = float2short(row[i]);
  }
}

// ---------------------------------------------------------------------------
// DRED entropy coding (mirror of dred/entropy.py, byte-compatible)
// ---------------------------------------------------------------------------
//
// Binary range coder with Q15 probabilities over a byte buffer; carries
// ripple backward through emitted bytes (payloads are small). Latent symbols
// decompose into zero-flag(p0) / sign(1/2) / geometric-continue(r) decisions
// exactly as the Python reference implementation.

static const uint32_t kRcTopByte = 1u << 24;
static const int kDredMaxMag = 255;

struct RangeEnc {
  uint8_t* out;
  int64_t pos, cap;
  uint32_t low, range;
};

static void rc_init(RangeEnc* rc, uint8_t* out, int64_t cap) {
  rc->out = out; rc->pos = 0; rc->cap = cap;
  rc->low = 0; rc->range = 0xFFFFFFFFu;
}

static void rc_carry(RangeEnc* rc) {
  int64_t i = (rc->pos < rc->cap ? rc->pos : rc->cap) - 1;
  while (i >= 0 && rc->out[i] == 0xFF) rc->out[i--] = 0;
  if (i >= 0) rc->out[i]++;
}

static void rc_encode_bit(RangeEnc* rc, int bit, uint32_t p0_q15) {
  uint32_t split = (uint32_t)(((uint64_t)rc->range * p0_q15) >> 15);
  if (split < 1) split = 1;
  if (split > rc->range - 1) split = rc->range - 1;
  if (bit) {
    uint64_t nl = (uint64_t)rc->low + split;
    if (nl >> 32) rc_carry(rc);
    rc->low = (uint32_t)nl;
    rc->range -= split;
  } else {
    rc->range = split;
  }
  while (rc->range < kRcTopByte) {
    if (rc->pos < rc->cap) rc->out[rc->pos] = (uint8_t)(rc->low >> 24);
    rc->pos++;
    rc->low <<= 8;
    rc->range <<= 8;
  }
}

static int64_t rc_finish(RangeEnc* rc) {
  // pick the codeword in [low, low+range) with the most trailing zero bytes
  for (int m = 4; m >= 0; m--) {
    uint64_t step = 1ull << (8 * m);
    uint64_t c = ((uint64_t)rc->low + step - 1) / step * step;
    if (c < (uint64_t)rc->low + rc->range) {
      if (c >> 32) rc_carry(rc);
      rc->low = (uint32_t)c;
      break;
    }
  }
  for (int i = 0; i < 4; i++) {
    if (rc->pos < rc->cap) rc->out[rc->pos] = (uint8_t)(rc->low >> 24);
    rc->pos++;
    rc->low <<= 8;
  }
  while (rc->pos > 0 && rc->pos <= rc->cap && rc->out[rc->pos - 1] == 0)
    rc->pos--;
  return rc->pos;  // > cap signals overflow to the caller
}

// zq [n] int symbols, p0/r [n] Q15. Returns payload length, or -1 if cap hit.
int64_t dred_encode_latents(const int32_t* zq, const uint16_t* p0,
                            const uint16_t* r, int64_t n,
                            uint8_t* out, int64_t cap) {
  RangeEnc rc;
  rc_init(&rc, out, cap);
  for (int64_t i = 0; i < n; i++) {
    uint32_t p = p0[i] < 1 ? 1 : (p0[i] > 32767 ? 32767 : p0[i]);
    uint32_t rr = r[i] < 1 ? 1 : (r[i] > 32767 ? 32767 : r[i]);
    int32_t z = zq[i];
    if (z == 0) { rc_encode_bit(&rc, 0, p); continue; }
    rc_encode_bit(&rc, 1, p);
    rc_encode_bit(&rc, z < 0 ? 1 : 0, 1u << 14);
    int mag = z < 0 ? -z : z;
    if (mag > kDredMaxMag) mag = kDredMaxMag;
    uint32_t p_stop = 32768u - rr;
    for (int j = 0; j < mag - 1; j++) rc_encode_bit(&rc, 1, p_stop);
    if (mag < kDredMaxMag) rc_encode_bit(&rc, 0, p_stop);
  }
  int64_t len = rc_finish(&rc);
  return len > cap ? -1 : len;
}

struct RangeDec {
  const uint8_t* data;
  int64_t len, pos;
  uint64_t diff;     // code - low; always < range
  uint32_t range;
};

static void rd_init(RangeDec* rd, const uint8_t* data, int64_t len) {
  rd->data = data; rd->len = len; rd->pos = 4;
  rd->range = 0xFFFFFFFFu;
  rd->diff = 0;
  for (int i = 0; i < 4; i++)
    rd->diff = (rd->diff << 8) | (i < len ? data[i] : 0);
}

static int rd_decode_bit(RangeDec* rd, uint32_t p0_q15) {
  uint32_t split = (uint32_t)(((uint64_t)rd->range * p0_q15) >> 15);
  if (split < 1) split = 1;
  if (split > rd->range - 1) split = rd->range - 1;
  int bit;
  if (rd->diff < split) {
    bit = 0;
    rd->range = split;
  } else {
    bit = 1;
    rd->diff -= split;
    rd->range -= split;
  }
  while (rd->range < kRcTopByte) {
    uint8_t nxt = rd->pos < rd->len ? rd->data[rd->pos] : 0;
    rd->pos++;
    rd->diff = (rd->diff << 8) | nxt;
    rd->range <<= 8;
  }
  return bit;
}

void dred_decode_latents(const uint8_t* data, int64_t len,
                         const uint16_t* p0, const uint16_t* r,
                         int64_t n, int32_t* out) {
  RangeDec rd;
  rd_init(&rd, data, len);
  for (int64_t i = 0; i < n; i++) {
    uint32_t p = p0[i] < 1 ? 1 : (p0[i] > 32767 ? 32767 : p0[i]);
    uint32_t rr = r[i] < 1 ? 1 : (r[i] > 32767 ? 32767 : r[i]);
    if (rd_decode_bit(&rd, p) == 0) { out[i] = 0; continue; }
    int sign = rd_decode_bit(&rd, 1u << 14) ? -1 : 1;
    uint32_t p_stop = 32768u - rr;
    int mag = 1;
    while (mag < kDredMaxMag && rd_decode_bit(&rd, p_stop) == 1) mag++;
    out[i] = sign * mag;
  }
}

// ---------------------------------------------------------------------------
// DRED payload framing, every stream of a batch in one call (mirror of
// dred/entropy.py::encode_payload): a 3-byte header (version | q0, q1 |
// n_latents), the PVQ state index big-endian in ceil(bits / 8) bytes, then
// the range-coded latents. The index runs in 128-bit arithmetic: DRED's
// 24-dim, 82-pulse codebook needs 96 bits.
// ---------------------------------------------------------------------------

typedef unsigned __int128 u128;

// V(n, k), the number of n-dim vectors of k pulses (models/rdovae.py's
// pvq_codebook_size), for n <= state_dim, k <= state_k into v
// [(state_dim + 1) * (state_k + 1)]; false where a count passes 127 bits.
static bool pvq_counts(int64_t state_dim, int64_t state_k, std::vector<u128>& v) {
  const int64_t kk = state_k + 1;
  const u128 limit = (u128)1 << 127;
  v.assign((state_dim + 1) * kk, 0);
  for (int64_t n = 0; n <= state_dim; n++) {
    for (int64_t k = 0; k <= state_k; k++) {
      u128 s = k == 0 ? 1 : 0;
      if (n > 0 && k > 0) {
        s = v[(n - 1) * kk + k] + v[n * kk + k - 1];
        if (s >= limit) return false;
        s += v[(n - 1) * kk + k - 1];
        if (s >= limit) return false;
      }
      v[n * kk + k] = s;
    }
  }
  return true;
}

// zq [B, L, D] symbols, pulses [B, S] with sum |.| == state_k, p0/r [L, D]
// Q15 of the payload's levels. Payloads are written back to back into out
// (cap bytes), their lengths into lengths [B]. Returns the bytes written;
// -1: out of room; -2: a stream's pulses do not sum to state_k; -3: a
// header field out of range or a codebook past 127 bits.
int64_t dred_frame_payloads(const int16_t* zq, const int16_t* pulses,
                            int64_t n_streams, int64_t n_latents,
                            int64_t latent_dim, int64_t state_dim,
                            int64_t state_k, const uint16_t* p0,
                            const uint16_t* r, int64_t q0, int64_t q1,
                            uint8_t* out, int64_t cap, int64_t* lengths) {
  if (n_latents < 1 || n_latents >= 4096 || q0 < 0 || q0 > 15 || q1 < 0 ||
      q1 > 15 || state_dim < 1 || state_k < 0)
    return -3;
  const int64_t kk = state_k + 1;
  std::vector<u128> v;
  if (!pvq_counts(state_dim, state_k, v)) return -3;
  int sbits = 0;
  for (u128 x = v[state_dim * kk + state_k] - 1; x; x >>= 1) sbits++;
  const int64_t nsb = (std::max(sbits, 1) + 7) / 8;
  const int64_t n_sym = n_latents * latent_dim;
  std::vector<int32_t> row(n_sym);
  int64_t pos = 0;
  for (int64_t b = 0; b < n_streams; b++) {
    const int16_t* y = pulses + b * state_dim;
    int64_t total = 0;
    for (int64_t j = 0; j < state_dim; j++) total += y[j] < 0 ? -y[j] : y[j];
    if (total != state_k) {
      lengths[b] = -2;
      return -2;
    }
    // the enumerative index: per position, magnitude 0 first, then +1, -1,
    // +2, -2, ... (dred/entropy.py::pvq_encode_index)
    u128 idx = 0;
    int64_t k = state_k;
    for (int64_t j = 0; j < state_dim; j++) {
      const int64_t a = y[j] < 0 ? -y[j] : y[j];
      const u128* vr = &v[(state_dim - j - 1) * kk];
      if (a != 0) {
        idx += vr[k];
        for (int64_t m = 1; m < a; m++) idx += 2 * vr[k - m];
        if (y[j] < 0) idx += vr[k - a];
      }
      k -= a;
    }
    const int64_t head = 3 + nsb;
    if (pos + head > cap) return -1;
    uint8_t* o = out + pos;
    o[0] = (uint8_t)((1 << 4) | q0);
    o[1] = (uint8_t)((q1 << 4) | (n_latents >> 8));
    o[2] = (uint8_t)(n_latents & 0xFF);
    for (int64_t i = 0; i < nsb; i++)
      o[3 + i] = (uint8_t)(idx >> (8 * (nsb - 1 - i)));
    const int16_t* z = zq + b * n_sym;
    for (int64_t i = 0; i < n_sym; i++) row[i] = z[i];
    const int64_t len = dred_encode_latents(row.data(), p0, r, n_sym, o + head,
                                            cap - pos - head);
    if (len < 0) return -1;
    lengths[b] = head + len;
    pos += head + len;
  }
  return pos;
}

// ---------------------------------------------------------------------------
// DRED payload parsing, every stream of a batch in one call: the inverse of
// dred_frame_payloads (mirror of dred/entropy.py::decode_payload). Per
// payload: the header, the PVQ index read big-endian and decoded to pulses
// in 128-bit arithmetic, the levels of its latents (payload_q_ids: q1 for
// the oldest to q0 for the newest, rounded half to even as numpy rounds),
// and the latents range-decoded with the tables' rows of those levels.
// ---------------------------------------------------------------------------

// data: n_streams payloads back to back, lengths [B]; p0/r [levels, D] Q15
// tables of every level. Row b of out [B, L * D + S + L] int16: stream b's
// symbols (oldest latent first, dims ascending), its pulses, its latents'
// levels. Returns 0; or, with the stream at fault in *bad: -1 shorter than
// its header and index; -2 an unknown version; -3 a latent count other than
// n_latents; -4 a level past the tables; -5 an index past the codebook; -6
// a codebook past 127 bits (bad = -1).
int64_t dred_parse_payloads(const uint8_t* data, const int64_t* lengths,
                            int64_t n_streams, int64_t n_latents,
                            int64_t latent_dim, int64_t state_dim,
                            int64_t state_k, const uint16_t* p0,
                            const uint16_t* r, int64_t levels, int16_t* out,
                            int64_t* bad) {
  *bad = -1;
  std::vector<u128> v;
  if (n_latents < 1 || state_dim < 1 || state_k < 0 ||
      !pvq_counts(state_dim, state_k, v))
    return -6;
  const int64_t kk = state_k + 1;
  const u128 total = v[state_dim * kk + state_k];
  int sbits = 0;
  for (u128 x = total - 1; x; x >>= 1) sbits++;
  const int64_t nsb = (std::max(sbits, 1) + 7) / 8;
  const int64_t head = 3 + nsb;
  const int64_t n_sym = n_latents * latent_dim;
  const int64_t row_len = n_sym + state_dim + n_latents;
  std::vector<int32_t> sym(n_sym);
  std::vector<uint16_t> p0_row(n_sym), r_row(n_sym);
  std::vector<int64_t> q(n_latents);
  int64_t q_pair = -1;  // the (q0, q1) whose rows p0_row and r_row hold
  const uint8_t* d = data;
  for (int64_t b = 0; b < n_streams; d += lengths[b], b++) {
    *bad = b;
    const int64_t len = lengths[b];
    if (len < head) return -1;
    if (d[0] >> 4 != 1) return -2;
    if ((((int64_t)d[1] & 0xF) << 8 | d[2]) != n_latents) return -3;
    const int64_t q0 = d[0] & 0xF, q1 = d[1] >> 4;
    if (q0 >= levels || q1 >= levels) return -4;
    u128 idx = 0;
    for (int64_t i = 0; i < nsb; i++) idx = idx << 8 | d[3 + i];
    if (idx >= total) return -5;
    int16_t* o = out + b * row_len;
    // pulses (dred/entropy.py::pvq_decode_index): per position the zero
    // block, then +1, -1, +2, -2, ...
    int16_t* y = o + n_sym;
    int64_t k = state_k;
    for (int64_t j = 0; j < state_dim; j++) {
      const u128* vr = &v[(state_dim - j - 1) * kk];
      int64_t val = 0;
      if (idx >= vr[k]) {
        idx -= vr[k];
        for (int64_t m = 1; m <= k; m++) {
          const u128 block = vr[k - m];
          if (idx < block) { val = m; break; }
          idx -= block;
          if (idx < block) { val = -m; break; }
          idx -= block;
        }
      }
      y[j] = (int16_t)val;
      k -= val < 0 ? -val : val;
    }
    if ((q1 << 4 | q0) != q_pair) {
      q_pair = q1 << 4 | q0;
      for (int64_t l = 0; l < n_latents; l++) {
        q[l] = n_latents == 1 ? q0 : (int64_t)std::nearbyint(
            (double)q1 + (double)((q0 - q1) * l) / (double)(n_latents - 1));
        std::memcpy(&p0_row[l * latent_dim], p0 + q[l] * latent_dim,
                    latent_dim * sizeof(uint16_t));
        std::memcpy(&r_row[l * latent_dim], r + q[l] * latent_dim,
                    latent_dim * sizeof(uint16_t));
      }
    }
    dred_decode_latents(d + head, len - head, p0_row.data(), r_row.data(),
                        n_sym, sym.data());
    for (int64_t i = 0; i < n_sym; i++) o[i] = (int16_t)sym[i];
    for (int64_t l = 0; l < n_latents; l++) o[n_sym + state_dim + l] = (int16_t)q[l];
  }
  *bad = -1;
  return 0;
}

}  // extern "C"
