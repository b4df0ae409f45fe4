// Kernel B: the tracking stage, one team of threads per candidate.
//
// Replaces lora_tpu/ops/pallas_demod.py:_track_flat (entry `track`) and
// _track_direct (entry `track_direct`), both built by
// _track_kernel_factory.  It computes what models/demodulator._scan_track
// computes on the plain route: up to 13 scan steps, each detecting window k
// under the carried fine CFO, matching (v+4)/8 against the first sync
// nibble and the lookahead window k+1 against the second, integrating the
// fractional bin and resetting it on squelch; then the downchirp pair at
// k_sync+2 and +3 gives the coarse CFO with C truncation.
//
// What bounds it on the H100: a candidate reads at most 17 windows (8
// B/sample; 0.57 GB at SF10 for 4096 candidates) at about 5*log2(N) flop
// per sample, far under the card's rates: the stage is bound by latency.
// The scan steps of a candidate depend on each other (the fine CFO of step
// k derotates step k+1), so parallelism comes from the candidates alone,
// and what counts is how many are in flight and how short a step is.
//
// So one team (detect.cuh: a warp at N = 1024) owns one candidate and walks
// its windows by itself; a block holds several teams, which share the pass
// twiddles in shared memory and nothing else.  The scan state lives in the
// team's registers: detect_window returns the same result to every thread
// of the team, so every thread takes every decision, and after the block
// has built its twiddles there is no block-wide barrier and no thread that
// decides for others.  The lookahead's bin enters only the sync test, which
// can hold only while searching, unsquelched, with the previous nibble 0 and
// this one the first sync nibble: the lookahead window is detected only
// then (same window, same carried CFO, so the same decision as detecting it
// at every step).  Once the sync is found no later step changes any output,
// so the scan ends there.  The team's windows (scan steps, lookaheads, the
// downchirp pair) all go through one call of the window routine in a small
// state machine, so the kernel holds one copy of that routine's code.  A candidate transforms k_sync + 4 windows or so
// where a scan of 13 pairs transformed 28 (5.51 on average on the SF10 bank
// of 4096 channels, whose aligned starts put the sync at step 1 or 2).
//
// Window k is read at its own sample offset, x[b, t0 + k*N : t0 + (k+1)*N],
// so the Pallas kernels' row gather, sub-window roll or blend and 8-row
// alignment have no counterpart here (the two dechirp tables stay in device
// memory, read through L1).  With max_frames = K a channel has K candidates
// (frame slots), each with its own t0: candidate m reads channel m / K of
// the same buffers.
//
// Tried and not kept (NVIDIA H100 80GB HBM3, 700.00 W, SF10, 4096
// candidates, one call, in turns): asking window k+2 into L2 while window k
// is transformed (prefetch.global.L2 a line: the address does not depend on
// the scan's decisions), 0.233 ms against 0.210 ms without: the scan now
// ends after two or three steps, and the lines asked for beyond it are
// traffic for nothing.  __launch_bounds__(128, 4), which caps the 168
// registers of N = 1024 at 128 for a fourth block on an SM: 0.233 against
// 0.233 ms, no difference.  The dechirp tables in shared memory, 0.214
// against 0.212 ms; blocks of 256 threads, 0.230 against 0.212.  A call of
// the window routine for each of step, lookahead and the two downchirps
// (four copies of its code): 0.225 against 0.173 ms with two copies and
// 0.161 with one, and ptxas spilled 4 to 8 bytes in some sizes where the
// single copy spills none (128 registers at N = 1024).

#include "detect.cuh"

namespace lora {

constexpr int kScan = 13;          // MAX_SYNC_SEARCH
constexpr int kTrackWindows = 17;  // scan + 2 downchirps + quarter margin
constexpr int kTrackThreads = 128;

template <int L>
__global__ void __launch_bounds__(kTrackThreads)
track_kernel(const float2* __restrict__ x, long long sB, long long B,
             long long T, int K, const int* __restrict__ t0, int sync0,
             int sync1, float thresh, const float2* __restrict__ up,
             const float2* __restrict__ down, const float2* __restrict__ tw_g,
             float rot_scale, float db_scale, int* __restrict__ o_state,
             int* __restrict__ o_ksync, int* __restrict__ o_freq,
             float* __restrict__ o_fine, float* __restrict__ o_power,
             float* __restrict__ o_snr) {
  extern __shared__ float2 smem[];
  using G = Geo<L>;
  constexpr int N = G::N;
  constexpr int kTeams = kTrackThreads / G::T;
  const int team = threadIdx.x / G::T;
  const int lane = threadIdx.x % G::T;
  float2* tw = smem;
  float2* s = tw + G::kTw + team * G::kBuf;
  build_twiddles<L>(tw_g, tw);
  __syncthreads();  // the only block-wide barrier: the teams part here

  const long long b = (long long)blockIdx.x * kTeams + team;
  if (b >= B) return;
  // callers pass t0 clipped to [0, T - 18N]; the clamp only keeps reads
  // inside the buffer
  long long start = t0[b];
  const long long hi = T - (long long)kTrackWindows * N;
  start = start < 0 ? 0 : (start > hi ? hi : start);
  const float2* xb = x + (b / K) * sB + start;

  // The team walks its windows through one call of the window routine (one
  // copy of its code in the kernel), as a small state machine whose state
  // is the same in every thread of the team.  Window k + phase is detected:
  //   kStep   window k of the scan, under the carried fine CFO;
  //   kLook   window k + 1, the lookahead of step k, under the same CFO;
  //   kDown0, kDown1   the downchirp pair at k_sync + 2 and + 3 (k is
  //           k_sync by then, 0 without a sync).
  enum { kStep = 0, kLook = 1, kDown0 = 2, kDown1 = 3 };
  int phase = kStep, k = 0, prev_q = 999, v_sum = 0;
  bool synced = false;
  float ferr = 0.0f, ferr_look = 0.0f;
  DetectOut o;
  for (;;) {
    o = detect_window<L, true>(xb + (long long)(k + phase) * N,
                               phase < kDown0 ? up : down, tw,
                               rot_scale * ferr, true, db_scale, s, lane, team);
    if (phase >= kDown0) {
      v_sum += o.value > N / 2 ? o.value - N : o.value;  // the signed bin
      if (phase == kDown1) break;
      phase = kDown1;
      continue;
    }
    if (phase == kStep) {
      const bool squelched = (o.power - o.noise) < thresh;
      const int q = (o.value + 4) / 8;
      if (!squelched && prev_q == 0 && q == sync0) {
        // the sync test reads the lookahead: detect it next; ferr_look is
        // what the CFO becomes if that is no sync after all
        ferr_look = ferr + o.findex;
        phase = kLook;
        continue;
      }
      ferr = squelched ? 0.0f : ferr + o.findex;
      prev_q = q;
    } else {
      synced = (o.value + 4) / 8 == sync1;
      if (synced) {
        phase = kDown0;  // k is k_sync; no later step changes an output
        continue;
      }
      ferr = ferr_look;
      prev_q = sync0;
      phase = kStep;
    }
    if (++k == kScan) {
      k = 0;  // no sync: the downchirp pair of k_sync = 0
      phase = kDown0;
    }
  }
  if (lane == 0) {
    const int freq_error = v_sum / 2;  // C division: toward zero
    o_state[b] = synced ? 1 : 0;
    o_ksync[b] = k;
    o_freq[b] = freq_error;
    o_fine[b] = ferr + (float)(freq_error / 2);
    o_power[b] = o.power;  // of the second downchirp window
    o_snr[b] = o.power - o.noise;
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
  constexpr int kTeams = kTrackThreads / G::T;
  const size_t smem = (size_t)(G::kTw + kTeams * G::kBuf) * sizeof(float2);
  static Resident cache{};
  long long fit = 0;  // one team per candidate: only the opt-in matters here
  cudaError_t err =
      resident_blocks(track_kernel<L>, kTrackThreads, smem, cache, &fit);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (B + kTeams - 1) / kTeams;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  track_kernel<L><<<(unsigned)blocks, kTrackThreads, smem, stream>>>(
      x, sB, B, T, K, t0, sync0, sync1, thresh, up, down, tw, rot_scale,
      db_scale, state, k_sync, freq_error, fine_total, power, snr);
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
