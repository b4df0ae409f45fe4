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
// transcendentals per sample for the derotation; the mag2 output adds 4
// bytes written per sample.  The three Pallas
// variants differ only in how they fit the row selection to Mosaic and
// VMEM; here each window is read at its own offset, so one kernel covers
// all three, with the block layout of kernel A.

#include "detect.cuh"

namespace lora {

template <bool kMag2>
__global__ void __launch_bounds__(256)
payload_kernel(const float2* __restrict__ x, long long sB, long long T,
               int mtu, long long B, int K,
               const int* __restrict__ data_start,
               const float* __restrict__ fine, DetectConsts c,
               int* __restrict__ value, float* __restrict__ power,
               float* __restrict__ noise, float* __restrict__ mag2) {
  extern __shared__ float2 smem[];
  const int tpw = team_threads(c.N);
  const int team = threadIdx.x / tpw;
  const int lane = threadIdx.x - team * tpw;
  const long long M = B * mtu;
  const long long m = (long long)blockIdx.x * (blockDim.x / tpw) + team;
  const long long mm = m < M ? m : M - 1;
  const long long b = mm / mtu;
  const long long w = mm - b * mtu;
  // callers pass data_start clipped to the payload room; the clamp only
  // keeps reads inside the buffer
  long long start = data_start[b];
  const long long hi = T - (long long)mtu * c.N;
  start = start < 0 ? 0 : (start > hi ? hi : start);
  const DetectOut o = detect_window<false, kMag2>(
      x + (b / K) * sB + start + w * c.N, c, fine[b], true,
      smem + team * team_smem(c.N), lane, tpw,
      kMag2 && m < M ? mag2 + m * c.N : nullptr);
  if (lane == 0 && m < M) {
    value[m] = o.value;
    power[m] = o.power;
    noise[m] = o.noise;
  }
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
  const DetectConsts c{static_cast<const float2*>(chirp),
                       static_cast<const float2*>(tw), N, log2_int(N),
                       rot_scale, db_scale};
  const int tpw = team_threads(N);
  const int threads = 256;
  const int wpb = threads / tpw;
  const long long blocks = (B * mtu + wpb - 1) / wpb;
  const size_t smem = (size_t)wpb * team_smem(N) * sizeof(float2);
  auto kernel = mag2 ? payload_kernel<true> : payload_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(x), sB, T, mtu, B, K,
      static_cast<const int*>(data_start), static_cast<const float*>(fine), c,
      static_cast<int*>(value), static_cast<float*>(power),
      static_cast<float*>(noise), static_cast<float*>(mag2));
  return (int)cudaGetLastError();
}
