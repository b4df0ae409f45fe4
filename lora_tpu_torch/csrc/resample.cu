// Kernel R: the fractional resampler's weighted sums, rows of complex IQ
// [rows, T] -> [rows, M], in one pass.
//
// Replaces no pallas_call: lora_tpu's `resample` (lora_tpu/ops/resample.py
// `_apply`) is one jitted gather and sum, which XLA fuses.  Output m of a
// row reads the `taps` inputs x[clamp(start[m] + j, 0, T - 1)], j = 0 ..
// taps - 1, and weighs them with its subfilter w = bank[phase[m], :].  The
// plan (start, phase) is one int32 table [2, M] made on the host in
// float64 (ops/resample.py `_plan`), shared by every row; the bank is the
// float32 [NPHASE, taps] table of ops/tables.py `resample_bank`.
//
// Float32 sequence, that of the plain route (`_apply`) step by step: for
// each plane, acc = x_0 * w_0, then acc = acc + x_j * w_j in the order j =
// 1 .. taps - 1, every product and sum rounded (`__fmul_rn`, `__fadd_rn`:
// nothing contracts to an fma), so the two routes agree bit for bit.
//
// What bounds it on the H100: the bytes, each input sample read once and
// each output written once, 8 a complex64 sample (about 4 * taps float32
// operations an output, 56 at the decimation by 8/5, is far below the
// float32 rate).  A block takes a tile of `tile` consecutive outputs over
// kResRows rows: it puts the tile's plan in shared memory once, then for
// each row stages the tile's input span (at most `span` samples: the
// tile's outputs at `ratio` inputs apart and the taps past the last) in
// shared memory with coalesced loads, so each input sample is read from
// device memory once a tile and not once a tap; consecutive threads then
// take consecutive outputs and store them coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace lora {

constexpr int kResThreads = 256;
constexpr int kResRows = 8;    // rows a block walks with one plan
constexpr int kResUnroll = 4;  // loads a thread has in flight while staging

__global__ void __launch_bounds__(kResThreads)
resample_kernel(const float2* __restrict__ x, long long rows, long long T,
                long long row_stride, long long col_stride,
                const int* __restrict__ plan, long long M, int taps,
                const float* __restrict__ bank, int tile,
                float2* __restrict__ out) {
  extern __shared__ int2 res_smem[];
  int2* pl = res_smem;                                  // [tile]
  float2* xs = reinterpret_cast<float2*>(res_smem + tile);  // [span]
  const long long m0 = (long long)blockIdx.x * tile;
  const int nt = (int)(M - m0 < tile ? M - m0 : tile);
  const long long s0 = plan[m0];
  // the tile's plan: each output's first input relative to the span's,
  // and its subfilter's offset in the bank
  for (int i = threadIdx.x; i < nt; i += kResThreads)
    pl[i] = make_int2((int)(plan[m0 + i] - s0), plan[M + m0 + i] * taps);
  const long long n = (long long)plan[m0 + nt - 1] + taps - s0;

  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float2* xr = x + r * row_stride;
    __syncthreads();  // the previous row's span is read; the plan written
    for (long long i0 = threadIdx.x; i0 < n;
         i0 += (long long)kResUnroll * kResThreads) {
      float2 v[kResUnroll];
#pragma unroll
      for (int u = 0; u < kResUnroll; ++u) {
        const long long i = i0 + (long long)u * kResThreads;
        long long g = s0 + i;
        g = g < 0 ? 0 : (g > T - 1 ? T - 1 : g);
        if (i < n) v[u] = __ldcs(xr + g * col_stride);
      }
#pragma unroll
      for (int u = 0; u < kResUnroll; ++u) {
        const long long i = i0 + (long long)u * kResThreads;
        if (i < n) xs[i] = v[u];
      }
    }
    __syncthreads();
    float2* orow = out + r * M + m0;
    for (int i = threadIdx.x; i < nt; i += kResThreads) {
      const int2 p = pl[i];
      const float2* v = xs + p.x;
      const float* w = bank + p.y;
      float wj = __ldg(w);
      float ar = __fmul_rn(v[0].x, wj), ai = __fmul_rn(v[0].y, wj);
      for (int j = 1; j < taps; ++j) {
        wj = __ldg(w + j);
        ar = __fadd_rn(ar, __fmul_rn(v[j].x, wj));
        ai = __fadd_rn(ai, __fmul_rn(v[j].y, wj));
      }
      orow[i] = make_float2(ar, ai);
    }
  }
}

}  // namespace lora

// x: complex64 rows, sample t of row r at x[r * row_stride + t *
// col_stride] (strides in samples), t < T; plan: int32 [2, M] contiguous,
// plan[0] each output's first input index (its taps clamped to [0, T - 1]
// here) non-decreasing in m, plan[1] its subfilter in [0, NPHASE); bank:
// float32 [NPHASE, taps] contiguous; out: complex64 [rows, M] contiguous.
// tile outputs a block; span >= plan[0][m + tile - 1] + taps - plan[0][m]
// for every tile, which the caller bounds from the ratio
// (ops/cuda_resample.py `geometry`).  Returns a CUDA error code.
extern "C" int lora_resample(const void* x, long long rows, long long T,
                             long long row_stride, long long col_stride,
                             const void* plan, long long M, int taps,
                             const void* bank, int tile, int span, void* out,
                             void* stream) {
  using namespace lora;
  if (rows == 0 || M == 0) return 0;
  if (T < 1 || taps < 1 || tile < 1 || span < taps)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tile * sizeof(int2) + (size_t)span * 8;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long tiles = (M + tile - 1) / tile;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  long long by = (rows + kResRows - 1) / kResRows;
  by = by < 65535 ? by : 65535;
  const dim3 grid((unsigned)tiles, (unsigned)by);
  resample_kernel<<<grid, kResThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(x), rows, T, row_stride, col_stride,
      static_cast<const int*>(plan), M, taps,
      static_cast<const float*>(bank), tile, static_cast<float2*>(out));
  return (int)cudaGetLastError();
}
