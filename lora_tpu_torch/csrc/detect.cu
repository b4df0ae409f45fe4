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
// the card's float32 rate for that traffic.  Between the two lies the data
// path of L1 and shared memory, 128 bytes per clock per SM: detect.cuh's
// routine sends 32 bytes per sample over it at N <= 1024 (16 for the one
// exchange of the register FFT, 8 for the dechirp entry, 8 for the pass
// twiddle), four times what comes from device memory.  So the kernel reads
// each sample exactly once, straight from the channel buffer into
// registers (window (b, w) of a [B, W, N] view is x + b*sB + w*N: no gather
// and no copy), and writes 16 bytes per window.
//
// Grid: as many blocks of 256 threads as the card holds at once; a block
// builds the dechirp table and the pass twiddles in shared memory once,
// and each of its 256/T teams (detect.cuh: T = 32 at N = 1024, one warp a
// window, 32 samples a thread) then walks over windows by itself, with no
// block-wide barrier after the tables.

#include "detect.cuh"

namespace lora {

constexpr int kThreads = 256;

template <int L, bool kFindex>
__global__ void __launch_bounds__(kThreads, 2)
detect_kernel(const float2* __restrict__ x, long long sB, long long W,
              long long M, const float* __restrict__ fe,
              const float2* __restrict__ chirp_g,
              const float2* __restrict__ tw_g, float rot_scale, float db_scale,
              int* __restrict__ value, float* __restrict__ power,
              float* __restrict__ noise, float* __restrict__ findex) {
  using G = Geo<L>;
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* chirp = tw + G::kTw;
  float2* bufs = chirp + G::N;
  build_twiddles<L>(tw_g, tw);
  for (int i = threadIdx.x; i < G::N; i += kThreads) chirp[i] = __ldg(chirp_g + i);
  __syncthreads();

  constexpr int kTeams = kThreads / G::T;
  const int team = threadIdx.x / G::T;
  const int lane = threadIdx.x % G::T;
  float2* s = bufs + team * G::kBuf;
  for (long long m = (long long)blockIdx.x * kTeams + team; m < M;
       m += (long long)gridDim.x * kTeams) {
    const long long b = m / W;
    const long long w = m - b * W;
    const float f = fe != nullptr ? fe[m] : 0.0f;
    const DetectOut o = detect_window<L, kFindex>(
        x + b * sB + w * G::N, chirp, tw, rot_scale * f, fe != nullptr,
        db_scale, s, lane, team);
    if (lane == 0) {
      value[m] = o.value;
      power[m] = o.power;
      noise[m] = o.noise;
      if (kFindex) findex[m] = o.findex;
    }
  }
}

template <int L, bool kFindex>
int launch_detect(const float2* x, long long sB, long long W, long long M,
                  const float* fe, const float2* chirp, const float2* tw,
                  float rot_scale, float db_scale, int* value, float* power,
                  float* noise, float* findex, cudaStream_t stream) {
  using G = Geo<L>;
  constexpr int kTeams = kThreads / G::T;
  const size_t smem =
      (size_t)(G::kTw + G::N + kTeams * G::kBuf) * sizeof(float2);
  auto kernel = detect_kernel<L, kFindex>;
  static Resident cache{};
  long long fit = 0;
  cudaError_t err = resident_blocks(kernel, kThreads, smem, cache, &fit);
  if (err != cudaSuccess) return (int)err;
  // a grid that walks over the windows: what the card holds at once, or less
  const long long needed = (M + kTeams - 1) / kTeams;
  const unsigned blocks = (unsigned)(needed < fit ? needed : fit);
  kernel<<<blocks, kThreads, smem, stream>>>(x, sB, W, M, fe, chirp, tw,
                                             rot_scale, db_scale, value, power,
                                             noise, findex);
  return (int)cudaGetLastError();
}

template <int L>
int launch_detect_any(bool want_findex, const float2* x, long long sB,
                      long long W, long long M, const float* fe,
                      const float2* chirp, const float2* tw, float rot_scale,
                      float db_scale, int* value, float* power, float* noise,
                      float* findex, cudaStream_t stream) {
  return want_findex
             ? launch_detect<L, true>(x, sB, W, M, fe, chirp, tw, rot_scale,
                                      db_scale, value, power, noise, findex,
                                      stream)
             : launch_detect<L, false>(x, sB, W, M, fe, chirp, tw, rot_scale,
                                       db_scale, value, power, noise, findex,
                                       stream);
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
  LORA_FOR_WINDOW_SIZE(
      N, launch_detect_any, want_findex != 0, static_cast<const float2*>(x),
      sB, W, M, static_cast<const float*>(fe),
      static_cast<const float2*>(chirp), static_cast<const float2*>(tw),
      rot_scale, db_scale, static_cast<int*>(value),
      static_cast<float*>(power), static_cast<float*>(noise),
      static_cast<float*>(findex), (cudaStream_t)stream)
}
