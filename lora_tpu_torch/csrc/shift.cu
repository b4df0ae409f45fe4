// Kernel E: the per-channel sub-window shift of the unfused routes.
//
// Replaces lora_tpu/ops/shift.py:_shift_tpu (entry `shift_windows`).  Given
// the aligned rows g [BF, R, N] of each channel (or candidate) and its
// shift r in [0, N), window w of the output [BF, mtu, N] is
// g[b, w, r:] ++ g[b, w+1, :r].  The rows of a channel are contiguous, so
// the mtu windows together are one flat span of mtu*N samples that starts r
// samples into the channel's rows: the kernel is a copy at a per-channel
// offset.  The Pallas body (two row blocks joined, a roll by 2N - r, a
// second pre-shifted input, 24-window tiles) is how Mosaic reaches such an
// unaligned copy; none of it has a counterpart here.  IQ is complex64, so
// one launch moves what the JAX package moves in two (re, im).
//
// What bounds it on the H100: 8 bytes read and 8 bytes written per sample,
// no arithmetic.  One block copies a group of kPairsPerBlock sample pairs
// of one channel; a thread moves two samples at a time, with one 16-byte
// load where r is even (the source is then 16-byte aligned) and two 8-byte
// loads where it is odd, and always one 16-byte store.  Consecutive threads
// take consecutive pairs, so loads and stores coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace lora {

constexpr int kShiftThreads = 256;
constexpr int kPairsPerThread = 8;
constexpr int kPairsPerBlock = kShiftThreads * kPairsPerThread;

__global__ void __launch_bounds__(kShiftThreads)
shift_kernel(const float2* __restrict__ g, long long sB, long long span,
             const int* __restrict__ r, float2* __restrict__ out) {
  const long long b = blockIdx.x;
  const int rb = r[b];
  const float2* src = g + b * sB + rb;
  float4* dst = reinterpret_cast<float4*>(out + b * span);
  const long long pairs = span >> 1;
  const long long first = (long long)blockIdx.y * kPairsPerBlock + threadIdx.x;
  if ((rb & 1) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int j = 0; j < kPairsPerThread; ++j) {
      const long long i = first + (long long)j * kShiftThreads;
      if (i < pairs) __stcs(dst + i, __ldg(src4 + i));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPairsPerThread; ++j) {
      const long long i = first + (long long)j * kShiftThreads;
      if (i < pairs) {
        const float2 a = __ldg(src + 2 * i), c = __ldg(src + 2 * i + 1);
        __stcs(dst + i, make_float4(a.x, a.y, c.x, c.y));
      }
    }
  }
}

}  // namespace lora

// g: complex64 rows, channel b at g + b*sB (sB >= R*N samples, a multiple
// of 2 so that every channel starts 16-byte aligned, as g itself must);
// r int32 [BF] in [0, N); out complex64 [BF, mtu, N] contiguous.  The
// caller guarantees R >= mtu + 1, so the span r + [0, mtu*N) lies inside
// the channel's R*N samples.  N is even (a power of two >= 2).
extern "C" int lora_shift(const void* g, long long sB, long long BF, int N,
                          int mtu, const void* r, void* out, void* stream) {
  using namespace lora;
  if (BF == 0 || mtu == 0) return 0;
  const long long span = (long long)mtu * N;
  const long long pairs = span >> 1;
  const long long groups = (pairs + kPairsPerBlock - 1) / kPairsPerBlock;
  if (groups > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)BF, (unsigned)groups);
  shift_kernel<<<grid, kShiftThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(g), sB, span, static_cast<const int*>(r),
      static_cast<float2*>(out));
  return (int)cudaGetLastError();
}
