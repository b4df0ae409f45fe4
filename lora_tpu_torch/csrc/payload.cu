// Kernel C: the payload stage, mtu windows per candidate from data_start.
//
// Replaces lora_tpu/ops/pallas_demod.py:_payload_flat_pc and
// _payload_tiled (entry `payload_detect`) and _payload_direct (entry
// `payload_detect_direct`).  Window w of channel b is
// x[b, data_start + w*N : data_start + (w+1)*N]: up-dechirped, derotated
// by the channel's fine CFO, transformed and peak-searched (no fractional
// bin).  With max_frames = K a channel has K candidates (frame slots),
// each with its own data_start and fine CFO: candidate m reads channel
// m / K of the same buffers, so the bank is never copied K-fold.  With a
// non-null `mag2` the kernel also writes every window's |X|^2 in natural
// bin order (the Pallas kernels' `want_mag2` output, the input of the
// soft-decision decoder).  The squelch cut and packet framing stay in
// PyTorch (models/demodulator._payload_epilogue).
//
// What bounds it on the H100: 8 bytes per sample read once, mtu*N samples
// per channel (2.3 GB at SF10, mtu = 68, 4096 channels: about 0.7 ms at
// 3.35 TB/s), plus about 5*log2(N) flop per sample for the FFT and two
// complex products per sample for the derotation (a recurrence: detect.cuh);
// the mag2 output adds 4 bytes written per sample.  As in kernel A, the
// data path of L1 and shared memory (32 bytes per sample at N <= 1024,
// detect.cuh) lies between that floor and the kernel's time.
// The three Pallas variants differ only in how they fit the row selection
// to Mosaic and VMEM; here each window is read at its own offset, so one
// kernel covers all three, with the grid of kernel A: resident blocks whose
// teams walk over the windows, the tables built once per block.  A window
// starts at data_start, any sample of the row, so it is read by 8-byte
// loads, never outside [0, T) of its channel's row.  With two passes the
// |X|^2 leaves the registers in natural bin order, consecutive lanes
// storing consecutive bins.

#include "detect.cuh"

namespace lora {

constexpr int kThreads = 256;

template <int L, bool kMag2>
__global__ void __launch_bounds__(kThreads, 2)
payload_kernel(const float2* __restrict__ x, long long sB, long long T,
               int mtu, long long B, int K,
               const int* __restrict__ data_start,
               const float* __restrict__ fine,
               const float2* __restrict__ chirp_g,
               const float2* __restrict__ tw_g, float rot_scale, float db_scale,
               int* __restrict__ value, float* __restrict__ power,
               float* __restrict__ noise, float* __restrict__ mag2) {
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
  const long long M = B * mtu;
  const long long hi = T - (long long)mtu * G::N;
  for (long long m = (long long)blockIdx.x * kTeams + team; m < M;
       m += (long long)gridDim.x * kTeams) {
    const long long b = m / mtu;
    const long long w = m - b * mtu;
    // callers pass data_start clipped to the payload room; the clamp only
    // keeps reads inside the channel's row
    long long start = data_start[b];
    start = start < 0 ? 0 : (start > hi ? hi : start);
    const DetectOut o = detect_window<L, false, kMag2>(
        x + (b / K) * sB + start + w * G::N, chirp, tw, rot_scale * fine[b],
        true, db_scale, s, lane, team, kMag2 ? mag2 + m * G::N : nullptr);
    if (lane == 0) {
      value[m] = o.value;
      power[m] = o.power;
      noise[m] = o.noise;
    }
  }
}

template <int L, bool kMag2>
int launch_payload(const float2* x, long long sB, long long T, int mtu,
                   long long B, int K, const int* data_start,
                   const float* fine, const float2* chirp, const float2* tw,
                   float rot_scale, float db_scale, int* value, float* power,
                   float* noise, float* mag2, cudaStream_t stream) {
  using G = Geo<L>;
  constexpr int kTeams = kThreads / G::T;
  const size_t smem =
      (size_t)(G::kTw + G::N + kTeams * G::kBuf) * sizeof(float2);
  auto kernel = payload_kernel<L, kMag2>;
  static Resident cache{};
  long long fit = 0;
  cudaError_t err = resident_blocks(kernel, kThreads, smem, cache, &fit);
  if (err != cudaSuccess) return (int)err;
  // a grid that walks over the windows: what the card holds at once, or less
  const long long needed = (B * mtu + kTeams - 1) / kTeams;
  const unsigned blocks = (unsigned)(needed < fit ? needed : fit);
  kernel<<<blocks, kThreads, smem, stream>>>(x, sB, T, mtu, B, K, data_start,
                                             fine, chirp, tw, rot_scale,
                                             db_scale, value, power, noise,
                                             mag2);
  return (int)cudaGetLastError();
}

template <int L>
int launch_payload_any(bool want_mag2, const float2* x, long long sB,
                       long long T, int mtu, long long B, int K,
                       const int* data_start, const float* fine,
                       const float2* chirp, const float2* tw, float rot_scale,
                       float db_scale, int* value, float* power, float* noise,
                       float* mag2, cudaStream_t stream) {
  return want_mag2
             ? launch_payload<L, true>(x, sB, T, mtu, B, K, data_start, fine,
                                       chirp, tw, rot_scale, db_scale, value,
                                       power, noise, mag2, stream)
             : launch_payload<L, false>(x, sB, T, mtu, B, K, data_start, fine,
                                        chirp, tw, rot_scale, db_scale, value,
                                        power, noise, mag2, stream);
}

}  // namespace lora

// x: complex64 channel buffers, channel c at x + c*sB, T samples each;
// B candidates, K per channel (candidate m belongs to channel m / K);
// data_start int32 [B], fine float32 [B]; outputs [B, mtu]; mag2 float32
// [B, mtu, N] or null when not wanted.
extern "C" int lora_payload(const void* x, long long sB, long long B, int K,
                            long long T, int N, int mtu,
                            const void* data_start, const void* fine,
                            const void* chirp, const void* tw,
                            float rot_scale, float db_scale, void* value,
                            void* power, void* noise, void* mag2,
                            void* stream) {
  using namespace lora;
  if (B == 0 || mtu == 0) return 0;
  if (K < 1) return (int)cudaErrorInvalidValue;
  if (T < (long long)mtu * N) return (int)cudaErrorInvalidValue;
  LORA_FOR_WINDOW_SIZE(
      N, launch_payload_any, mag2 != nullptr, static_cast<const float2*>(x),
      sB, T, mtu, B, K, static_cast<const int*>(data_start),
      static_cast<const float*>(fine), static_cast<const float2*>(chirp),
      static_cast<const float2*>(tw), rot_scale, db_scale,
      static_cast<int*>(value), static_cast<float*>(power),
      static_cast<float*>(noise), static_cast<float*>(mag2),
      (cudaStream_t)stream)
}
