// Scalar pieces shared by the sample-loop kernels (masked_loop.cu: K1, K2,
// K3 and K6 in every form; sample_loop.cu: f32 K1 and K6 at the batches
// that take more than two waves of f32 clusters): the numeric forms, the
// u-law maps, KISS99, the GRU operand copy and the reset-after update. Scalar float code uses explicit _rn intrinsics where the plain
// PyTorch version rounds each operation, so nvcc cannot contract it into
// FMAs with a different rounding.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define LPC_ORDER 16

enum { FORM_F32 = 0, FORM_BF16 = 1, FORM_Q8 = 2 };

// constants as float32 roundings of the Python doubles the plain version uses
#define LOG256 ((float)5.5451774445)
#define ULAW_SCALE ((float)(255.0 / 32768.0))
#define ULAW_SCALE_1 ((float)(32768.0 / 255.0))
#define LN2_APPROX ((float)0.69315)
#define PREEMPH ((float)0.85)
#define Q8_SCALE ((float)(1.0 / (128.0 * 127.0)))

__device__ __forceinline__ float wload(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float wload(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ int wload(const int8_t* p, size_t i) { return (int)p[i]; }

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ int lin2ulaw(float x) {
  float s = x >= 0.f ? 1.f : -1.f;
  float logv = __fmul_rn(LN2_APPROX, log2f(__fadd_rn(1.f, __fmul_rn(ULAW_SCALE, fabsf(x)))));
  float u = __fadd_rn(128.f, __fmul_rn(s, __fdiv_rn(__fmul_rn(128.f, logv), LOG256)));
  u = fminf(fmaxf(u, 0.f), 255.f);
  return (int)floorf(__fadd_rn(0.5f, u));
}

__device__ __forceinline__ float ulaw2lin(int code) {
  float u = (float)code - 128.f;
  float s = u >= 0.f ? 1.f : -1.f;
  float e = expf(__fmul_rn(__fdiv_rn(fabsf(u), 128.f), LOG256));
  return __fmul_rn(__fmul_rn(s, ULAW_SCALE_1), __fsub_rn(e, 1.f));
}

__device__ __forceinline__ unsigned kiss99(unsigned* st) {
  unsigned z = st[0], w = st[1], jsr = st[2], jcong = st[3];
  z = 36969u * (z & 0xFFFFu) + (z >> 16);
  w = 18000u * (w & 0xFFFFu) + (w >> 16);
  unsigned mwc = (z << 16) + w;
  jsr ^= jsr << 13;
  jsr ^= jsr >> 17;
  jsr ^= jsr << 5;
  jcong = 69069u * jcong + 1234567u;
  st[0] = z; st[1] = w; st[2] = jsr; st[3] = jcong;
  return (mwc ^ jcong) + jsr;
}

// the GRU operand copy of a state value: bf16-rounded, quantized, or as is
template <int FORM>
__device__ __forceinline__ float operand(float h) {
  if (FORM == FORM_BF16) return __bfloat162float(__float2bfloat16_rn(h));
  if (FORM == FORM_Q8) {
    float q = floorf(__fadd_rn(0.5f, __fmul_rn(127.f, h)));
    return fminf(fmaxf(q, -128.f), 127.f);
  }
  return h;
}

__device__ __forceinline__ float gru_out(float gz, float rz, float gr, float rr,
                                         float gh, float rh, float h0) {
  float z = sigmoidf_(__fadd_rn(gz, rz));
  float r = sigmoidf_(__fadd_rn(gr, rr));
  float hc = tanhf(__fadd_rn(gh, __fmul_rn(r, rh)));
  return __fadd_rn(__fmul_rn(z, h0), __fmul_rn(__fsub_rn(1.f, z), hc));
}

// operand and accumulator types of a numeric form
template <int FORM> struct FormT {
  typedef typename std::conditional<FORM == FORM_F32, float,
      typename std::conditional<FORM == FORM_BF16, __nv_bfloat16, int8_t>::type>::type W;
  typedef typename std::conditional<FORM == FORM_Q8, int, float>::type Acc;
};
