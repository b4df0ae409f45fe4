// Complex helpers and the R-point FFT in registers (R = 2..32) that the
// port's kernels share: the window routine of kernels A, B, C (detect.cuh)
// and the K-point transform of kernel D (channelize.cu).
//
// The FFTs are radix-2, decimation in frequency, with the twiddles as
// literals and every loop bound a template constant: after unrolling every
// register index is a compile-time constant, so the values stay in
// registers.  Forward transform (exp(-2*pi*i*...)), natural order in,
// bit-reversed order out.
#pragma once

#include <cuda_runtime.h>

namespace lora {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__host__ __device__ constexpr int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// bit reversal of p over kBits <= 5 bits
template <int kBits>
__host__ __device__ constexpr int brev(int p) {
  return (((p & 1) << 4) | ((p & 2) << 2) | (p & 4) | ((p & 8) >> 2) |
          ((p & 16) >> 4)) >> (5 - kBits);
}

// x * exp(-2*pi*i * idx/32), idx in [0, 16), a constant once the caller's
// loops are unrolled
__device__ __forceinline__ float2 mul_w32(float2 x, int idx) {
  constexpr float kH = 0.70710678118654752f;
  float c, s;  // cos and sin of 2*pi*idx/32
  switch (idx) {
    case 0: return x;
    case 8: return make_float2(x.y, -x.x);
    case 4: return make_float2((x.x + x.y) * kH, (x.y - x.x) * kH);
    case 12: return make_float2((x.y - x.x) * kH, -(x.x + x.y) * kH);
    case 1: c = 0.98078528040323043f; s = 0.19509032201612825f; break;
    case 2: c = 0.92387953251128674f; s = 0.38268343236508978f; break;
    case 3: c = 0.83146961230254524f; s = 0.55557023301960218f; break;
    case 5: c = 0.55557023301960218f; s = 0.83146961230254524f; break;
    case 6: c = 0.38268343236508978f; s = 0.92387953251128674f; break;
    case 7: c = 0.19509032201612825f; s = 0.98078528040323043f; break;
    case 9: c = -0.19509032201612825f; s = 0.98078528040323043f; break;
    case 10: c = -0.38268343236508978f; s = 0.92387953251128674f; break;
    case 11: c = -0.55557023301960218f; s = 0.83146961230254524f; break;
    case 13: c = -0.83146961230254524f; s = 0.55557023301960218f; break;
    case 14: c = -0.92387953251128674f; s = 0.38268343236508978f; break;
    default: c = -0.98078528040323043f; s = 0.19509032201612825f; break;
  }
  return make_float2(x.x * c + x.y * s, x.y * c - x.x * s);
}

// One radix-2 stage of half-length H on v[0..R), and the stages below it.
// Every loop bound is a template constant, so the loops unroll fully and
// every index of v is a compile-time constant: v stays in registers.
template <int R, int H>
__device__ __forceinline__ void fft_stages(float2* v) {
#pragma unroll
  for (int b = 0; b < R; b += 2 * H) {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float2 a = v[b + i], c = v[b + i + H];
      v[b + i] = cadd(a, c);
      v[b + i + H] = mul_w32(csub(a, c), i * (16 / H));
    }
  }
  if constexpr (H > 1) fft_stages<R, H / 2>(v);
}

// R-point DFT of v[0..R) in registers, radix-2 decimation in frequency:
// natural order in, bit-reversed out (v[p] holds output brev<log2 R>(p)).
template <int R>
__device__ __forceinline__ void fft_reg(float2* v) {
  fft_stages<R, R / 2>(v);
}

}  // namespace lora
