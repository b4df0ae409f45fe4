// Kernel A: batched dechirp + DFT + peak search over M windows.
//
// Replaces lora_tpu/ops/pallas_detect.py:_detect_flat (bodies _kernel and
// _kernel4, entry dechirp_detect_pallas).  The demodulator's coarse
// preamble search runs it over every stride-N window of every channel:
// at SF10 with 4096 channels of 96 windows, M = 393,216 windows, 3.2 GB
// of complex64 IQ read once.
//
// What bounds it on the H100: reading 8 bytes per sample from device
// memory is the floor (3.2 GB at 3.35 TB/s is about 1 ms); the FFT costs
// about 5*log2(N) flop per sample, 50 flop/sample at N = 1024, far under
// the card's float32 rate for that traffic.  So the kernel reads each
// sample exactly once, straight from the channel buffer (window (b, w) of
// a [B, W, N] view is x + b*sB + w*N: no gather and no copy), keeps the
// dechirped window and its spectrum in shared memory, and writes 16 bytes
// per window.  The FFT is detect.cuh's radix-2^2 routine: its first pass
// reads the window from device memory, the middle passes work in shared
// memory, and the last pass feeds the peak search from registers.  Those
// shared-memory passes and their barriers, not device memory, are what a
// later version should cut.
//
// Grid: one block of 256 threads holds 256/tpw windows (tpw =
// team_threads(N), detect.cuh): four at N = 1024, one at N = 4096.

#include "detect.cuh"

namespace lora {

template <bool kFindex>
__global__ void __launch_bounds__(256)
detect_kernel(const float2* __restrict__ x, long long sB, long long W,
              long long M, const float* __restrict__ fe, DetectConsts c,
              int* __restrict__ value, float* __restrict__ power,
              float* __restrict__ noise, float* __restrict__ findex) {
  extern __shared__ float2 smem[];
  const int tpw = team_threads(c.N);
  const int team = threadIdx.x / tpw;
  const int lane = threadIdx.x - team * tpw;
  const long long m = (long long)blockIdx.x * (blockDim.x / tpw) + team;
  // a ragged last block still runs every thread through the block-wide
  // barriers, on a duplicate of the last window
  const long long mm = m < M ? m : M - 1;
  const long long b = mm / W;
  const long long w = mm - b * W;
  const float f = fe != nullptr ? fe[mm] : 0.0f;
  const DetectOut o =
      detect_window<kFindex>(x + b * sB + w * c.N, c, f, fe != nullptr,
                             smem + team * team_smem(c.N), lane, tpw);
  if (lane == 0 && m < M) {
    value[m] = o.value;
    power[m] = o.power;
    noise[m] = o.noise;
    if (kFindex) findex[m] = o.findex;
  }
}

}  // namespace lora

// Windows (b, w), b < B, w < W, start at x + b*sB + w*N (complex64
// elements).  fe is null (no derotation) or float32 [B*W].  chirp [N] and
// tw [N/2] are complex64 tables.  findex may be null when want_findex == 0.
extern "C" int lora_detect(const void* x, long long sB, long long B,
                           long long W, int N, const void* fe,
                           const void* chirp, const void* tw,
                           float rot_scale, float db_scale, int want_findex,
                           void* value, void* power, void* noise,
                           void* findex, void* stream) {
  using namespace lora;
  const long long M = B * W;
  if (M == 0) return 0;
  const DetectConsts c{static_cast<const float2*>(chirp),
                       static_cast<const float2*>(tw), N, log2_int(N),
                       rot_scale, db_scale};
  const int tpw = team_threads(N);
  const int threads = 256;
  const int wpb = threads / tpw;
  const long long blocks = (M + wpb - 1) / wpb;
  const size_t smem = (size_t)wpb * team_smem(N) * sizeof(float2);
  auto kernel = want_findex ? detect_kernel<true> : detect_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(x), sB, W, M, static_cast<const float*>(fe),
      c, static_cast<int*>(value), static_cast<float*>(power),
      static_cast<float*>(noise), static_cast<float*>(findex));
  return (int)cudaGetLastError();
}
