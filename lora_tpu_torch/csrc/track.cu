// Kernel B: the tracking stage, one block per candidate.
//
// Replaces lora_tpu/ops/pallas_demod.py:_track_flat (entry `track`) and
// _track_direct (entry `track_direct`), both built by
// _track_kernel_factory.  It computes what models/demodulator._scan_track
// computes on the plain route: 13 scan steps, each detecting window k and
// its lookahead k+1 under the carried fine CFO, matching (v+4)/8 against
// the two sync nibbles, integrating the fractional bin and resetting it on
// squelch; then the downchirp pair at k_sync+2 and +3 gives the coarse CFO
// with C truncation.  28 window detects per channel.
//
// What bounds it on the H100: each channel reads 17 windows (8 B/sample,
// 17*N samples; 0.57 GB at SF10 for 4096 channels) and transforms 28, at
// about 5*log2(N) flop per sample each.  The 13 steps are sequential
// within a channel, so parallelism comes from the channels: one block per
// channel, its two teams (detect.cuh: a warp each at N = 1024) detecting a
// step's window pair at once and meeting at the step's barrier.  Window k
// is read at its own sample offset, x[b, t0 + k*N : t0 + (k+1)*N], so the
// Pallas kernels' row gather, sub-window roll or blend and 8-row alignment
// have no counterpart here; the state lives in shared memory, beside the
// pass twiddles the block builds once (the two dechirp tables stay in
// device memory, read through L1: 28 windows do not repay a copy).  With
// max_frames = K a channel has K candidates (frame slots), each with its
// own t0: block m reads channel m / K of the same buffers.

#include "detect.cuh"

namespace lora {

constexpr int kScan = 13;          // MAX_SYNC_SEARCH
constexpr int kTrackWindows = 17;  // scan + 2 downchirps + quarter margin

template <int L>
__global__ void __launch_bounds__(2 * Geo<L>::T)
track_kernel(const float2* __restrict__ x, long long sB, long long T,
             int K, const int* __restrict__ t0, int sync0, int sync1,
             float thresh, const float2* __restrict__ up,
             const float2* __restrict__ down, const float2* __restrict__ tw_g,
             float rot_scale, float db_scale, int* __restrict__ o_state,
             int* __restrict__ o_ksync, int* __restrict__ o_freq,
             float* __restrict__ o_fine, float* __restrict__ o_power,
             float* __restrict__ o_snr) {
  extern __shared__ float2 smem[];
  __shared__ int st_state, st_prev_q, st_ksync;
  __shared__ float st_ferr;
  __shared__ int sh_value[2];
  __shared__ float sh_power[2], sh_noise[2], sh_findex[2];

  using G = Geo<L>;
  constexpr int N = G::N;
  const int team = threadIdx.x / G::T;
  const int lane = threadIdx.x % G::T;
  const long long b = blockIdx.x;
  // callers pass t0 clipped to [0, T - 18N]; the clamp only keeps reads
  // inside the buffer
  long long start = t0[b];
  const long long hi = T - (long long)kTrackWindows * N;
  start = start < 0 ? 0 : (start > hi ? hi : start);
  const float2* xb = x + (b / K) * sB + start;
  float2* tw = smem;
  float2* s = tw + G::kTw + team * G::kBuf;

  build_twiddles<L>(tw_g, tw);
  if (threadIdx.x == 0) {
    st_state = 0;
    st_ferr = 0.0f;
    st_prev_q = 999;
    st_ksync = 0;
  }
  __syncthreads();

  for (int k = 0; k < kScan; ++k) {
    const DetectOut o = detect_window<L, true>(
        xb + (long long)(k + team) * N, up, tw, rot_scale * st_ferr, true,
        db_scale, s, lane, team);
    if (lane == 0) {
      sh_value[team] = o.value;
      sh_power[team] = o.power;
      sh_noise[team] = o.noise;
      sh_findex[team] = o.findex;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const bool squelched = (sh_power[0] - sh_noise[0]) < thresh;
      const int q = (sh_value[0] + 4) / 8;
      const int q1 = (sh_value[1] + 4) / 8;
      const bool searching = st_state == 0;
      const bool is_sync = searching && !squelched && st_prev_q == 0 &&
                           q == sync0 && q1 == sync1;
      if (is_sync) {
        st_state = 1;
        st_ksync = k;
      }
      if (searching && !is_sync && !squelched) {
        st_ferr = st_ferr + sh_findex[0];
      } else if (searching && squelched) {
        st_ferr = 0.0f;
      }
      if (searching) st_prev_q = q;
    }
    __syncthreads();
  }

  // downchirp pair at k_sync+2 (team 0) and k_sync+3 (team 1)
  const DetectOut o = detect_window<L, false>(
      xb + (long long)(st_ksync + 2 + team) * N, down, tw, rot_scale * st_ferr,
      true, db_scale, s, lane, team);
  if (lane == 0) {
    sh_value[team] = o.value;
    sh_power[team] = o.power;
    sh_noise[team] = o.noise;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int v0 = sh_value[0] > N / 2 ? sh_value[0] - N : sh_value[0];
    const int v1 = sh_value[1] > N / 2 ? sh_value[1] - N : sh_value[1];
    const int freq_error = (v0 + v1) / 2;  // C division: toward zero
    o_state[b] = st_state;
    o_ksync[b] = st_ksync;
    o_freq[b] = freq_error;
    o_fine[b] = st_ferr + (float)(freq_error / 2);
    o_power[b] = sh_power[1];
    o_snr[b] = sh_power[1] - sh_noise[1];
  }
}

template <int L>
int launch_track(const float2* x, long long sB, long long B, int K,
                 long long T, const int* t0, int sync0, int sync1,
                 float thresh, const float2* up, const float2* down,
                 const float2* tw, float rot_scale, float db_scale, int* state,
                 int* k_sync, int* freq_error, float* fine_total, float* power,
                 float* snr, cudaStream_t stream) {
  using G = Geo<L>;
  const size_t smem = (size_t)(G::kTw + 2 * G::kBuf) * sizeof(float2);
  static Resident cache{};
  long long fit = 0;  // one block per candidate: only the opt-in matters here
  cudaError_t err =
      resident_blocks(track_kernel<L>, 2 * G::T, smem, cache, &fit);
  if (err != cudaSuccess) return (int)err;
  track_kernel<L><<<(unsigned)B, 2 * G::T, smem, stream>>>(
      x, sB, T, K, t0, sync0, sync1, thresh, up, down, tw, rot_scale, db_scale,
      state, k_sync, freq_error, fine_total, power, snr);
  return (int)cudaGetLastError();
}

}  // namespace lora

// x: complex64 channel buffers, channel c at x + c*sB, T samples each;
// B candidates, K per channel (candidate m belongs to channel m / K);
// t0 int32 [B].  up/down: complex64 dechirp tables [N]; tw [N/2].
extern "C" int lora_track(const void* x, long long sB, long long B, int K,
                          long long T, int N, const void* t0, int sync0,
                          int sync1, float thresh, const void* up,
                          const void* down, const void* tw, float rot_scale,
                          float db_scale, void* state, void* k_sync,
                          void* freq_error, void* fine_total, void* power,
                          void* snr, void* stream) {
  using namespace lora;
  if (B == 0) return 0;
  if (K < 1) return (int)cudaErrorInvalidValue;
  if (T < (long long)kTrackWindows * N) return (int)cudaErrorInvalidValue;
  LORA_FOR_WINDOW_SIZE(
      N, launch_track, static_cast<const float2*>(x), sB, B, K, T,
      static_cast<const int*>(t0), sync0, sync1, thresh,
      static_cast<const float2*>(up), static_cast<const float2*>(down),
      static_cast<const float2*>(tw), rot_scale, db_scale,
      static_cast<int*>(state), static_cast<int*>(k_sync),
      static_cast<int*>(freq_error), static_cast<float*>(fine_total),
      static_cast<float*>(power), static_cast<float*>(snr),
      (cudaStream_t)stream)
}
