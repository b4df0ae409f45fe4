// Shared dechirp -> DFT -> peak routine of the three Hopper kernels
// (detect.cu, track.cu, payload.cu), as the JAX package's fused kernels
// share `direct_vals` / `four_step_vals` (lora_tpu/ops/pallas_detect.py).
//
// What bounds the routine on the H100 is not device memory (8 bytes per
// sample, read once) but the one data path that L1 and shared memory
// share: 128 bytes per clock per SM.  So the transform lives in registers
// and crosses threads as rarely as the window size allows.
//
// A team of T = Plan<log2 N>::T threads owns one window of N samples (N a
// power of two, 64..4096) and a thread holds E = N/T of them (8 to 32).
// The DFT is a mixed-radix decimation in frequency, N = R0*R1 (N <= 1024)
// or R0*R1*R2 (N = 2048, 4096), every radix 8, 16 or 32:
//   pass 0  thread `lane` takes the columns c = lane + T*a, a < E/R0: the
//           samples c + (N/R0)*j, j < R0, straight from device memory (a
//           warp's load instruction reads 256 consecutive bytes), times the
//           dechirp entry (and the derotator); an R0-point FFT in
//           registers; output m times the pass twiddle W_N^(c*m); written
//           to position c + (N/R0)*m of the team's exchange buffer;
//   middle  (three passes only) the same on blocks of N/R0 positions, in
//           place;
//   last    thread `lane` takes the runs f = lane + T*a, a < E/Rl, of Rl
//           consecutive positions; an Rl-point FFT in registers leaves bin
//           kb(f) + S*m in register (a, m), S = N/Rl, and the peak search,
//           the total, the |X|^2 output and the fractional bin's
//           neighbours all read those registers with the bin known from
//           (lane, register).
// The in-register FFTs (fft.cuh) are radix-2 with the twiddles as literals,
// fully unrolled, so every register index is a compile-time constant.  A window
// of N <= 1024 crosses threads once: 16 bytes per sample through shared
// memory (one write, one read, both free of bank conflicts: the buffer
// has one float2 of padding per Rl), 8 for the dechirp entry and 8 for
// the pass twiddle, which the kernels keep in shared memory, built once
// per block: 32 bytes per sample in all.  N = 2048 and 4096 cross twice.
//
// Teams synchronise among themselves only: __syncwarp over the team's
// lanes for T <= 32 (a warp holds 32/T windows), a named barrier
// (bar.sync id, T) for the two- and four-warp teams of N = 2048 and 4096.
// The routine holds no __syncthreads(): teams of a block run windows
// independently, and a block walks over many windows.
//
// The reductions follow lora_tpu/ops/detect.py:64-91: peak bin (lowest
// index on ties), peak and residual power in dB, 3-point fractional bin.
//
// The derotator exp(i*rot*n) of a column's samples n = c + (N/R0)*j is a
// recurrence, exp(i*rot*c) * exp(i*rot*N/R0)^j: two sincosf a column (the
// step's angle is exact, N/R0 being a power of two) and one complex
// product a sample, where one sincosf a sample cost more instructions
// than the transform.  After at most 31 steps it is within 6.4e-6 of the
// exact rotator (tests/test_torch_fft_model.py), of the size of the plain
// version's float32 angle rot*n at a CFO of a few bins.
//
// Built without --use_fast_math: sincosf, log10f and sqrtf are the full
// precision functions, so the dB values follow the plain PyTorch version
// (ops/detect.py) to float32 rounding.
//
// Tried and not kept (NVIDIA H100 80GB HBM3, 700.00 W, SF10, 4096
// channels): 16-byte loads of column pairs with a shuffle between
// neighbouring lanes, 1.190 ms against 1.129 ms for kernel A.  A thread's
// 32 independent 8-byte loads already keep 8 KB a warp in flight, and the
// shuffles cost more than the halved load count saves.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "fft.cuh"

namespace lora {

struct DetectOut {
  int value;
  float power;
  float noise;
  float findex;
};

// The passes of each window size: P of them with radices R0, R1 (and R2),
// and the team size T.  Every pass has N/R FFTs, a multiple of T.  The
// radices are chosen so that the exchange is free of bank conflicts with
// one float2 of padding per run of the last radix.
template <int L> struct Plan;
template <> struct Plan<6>  { enum { P = 2, R0 = 8,  R1 = 8,  R2 = 1,  T = 8 }; };
template <> struct Plan<7>  { enum { P = 2, R0 = 16, R1 = 8,  R2 = 1,  T = 8 }; };
template <> struct Plan<8>  { enum { P = 2, R0 = 16, R1 = 16, R2 = 1,  T = 16 }; };
template <> struct Plan<9>  { enum { P = 2, R0 = 32, R1 = 16, R2 = 1,  T = 16 }; };
template <> struct Plan<10> { enum { P = 2, R0 = 32, R1 = 32, R2 = 1,  T = 32 }; };
template <> struct Plan<11> { enum { P = 3, R0 = 8,  R1 = 16, R2 = 16, T = 64 }; };
template <> struct Plan<12> { enum { P = 3, R0 = 32, R1 = 8,  R2 = 16, T = 128 }; };

template <int L> struct Geo {
  using Pl = Plan<L>;
  static constexpr int N = 1 << L;
  static constexpr int P = Pl::P, R0 = Pl::R0, R1 = Pl::R1, R2 = Pl::R2;
  static constexpr int T = Pl::T;
  static constexpr int E = N / T;               // samples a thread holds
  static constexpr int Rl = P == 2 ? R1 : R2;   // the last radix
  static constexpr int kPadShift = ilog2(Rl);
  static constexpr int Q0 = N / R0;             // columns of pass 0
  // float2 elements of a team's exchange buffer: the padded window; 8 more
  // where two 8-thread teams share a half-warp, so that their accesses fall
  // into different banks; 8 for the cross-warp reductions of T > 32
  static constexpr int kPadded = N + (N >> kPadShift);
  static constexpr int kBuf =
      kPadded + ((T == 8 && kPadded % 16 == 0) || T > 32 ? 8 : 0);
  // float2 elements of the pass twiddles: W_N^(c*m) as [m][c] for pass 0,
  // then W_Q0^(i*m) as [m][i] for the middle pass
  static constexpr int kTw = N + (P == 3 ? Q0 : 0);
  static_assert(E % R0 == 0 && E % R1 == 0 && E % Rl == 0 && E <= 32, "plan");
  static_assert(R0 * R1 * R2 == N, "plan");
};

__device__ __forceinline__ float to_db(float a, float scale) {
  return 20.0f * log10f(fmaxf(a, 1e-20f)) - scale;
}

// The lanes of this thread's team within its warp (T <= 32).
template <int T>
__device__ __forceinline__ unsigned team_mask() {
  if (T >= 32) return 0xffffffffu;
  return ((1u << (T & 31)) - 1u) << ((threadIdx.x & 31) & ~(T - 1));
}

// Barrier and memory fence among the threads of team `team` of the block.
template <int T>
__device__ __forceinline__ void team_sync(int team) {
  if constexpr (T <= 32) {
    __syncwarp(team_mask<T>());
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "n"(T) : "memory");
  }
}

// Build the pass twiddles of Geo<L> in shared memory from the table
// tw = exp(-2*pi*i*k/N), k < N/2; every thread of the block calls it, and
// the caller synchronises the block afterwards.
template <int L>
__device__ __forceinline__ void build_twiddles(const float2* __restrict__ tw,
                                               float2* out) {
  using G = Geo<L>;
  for (int i = threadIdx.x; i < G::kTw; i += blockDim.x) {
    int e;  // the exponent of W_N
    if (i < G::N) {
      e = (i / G::Q0) * (i % G::Q0);
    } else {
      constexpr int q = G::Q0 / G::R1;
      e = G::R0 * ((i - G::N) / q) * ((i - G::N) % q);
    }
    e &= G::N - 1;
    const float2 w = __ldg(tw + (e & (G::N / 2 - 1)));
    out[i] = e < G::N / 2 ? w : make_float2(-w.x, -w.y);
  }
}

// Detect the window `win` (N samples, 8-byte aligned) with the team of
// threads `lane` = 0..T-1, team `team` of the block, in the team's exchange
// buffer s (Geo<L>::kBuf float2).  `chirp` is the dechirp table [N], `tw`
// the pass twiddles of build_twiddles.  rotate=false skips the derotation
// by exp(i*rot*n) (the coarse search has no fine CFO).  kMag2 also writes
// the window's |X|^2 to `mag2`, N floats in natural bin order: the values
// the peak search compared, so `value` is the lowest bin of the largest
// one written.  Every thread of the team returns the same result.
template <int L, bool kFindex, bool kMag2 = false>
__device__ __forceinline__ DetectOut detect_window(
    const float2* __restrict__ win, const float2* chirp, const float2* tw,
    float rot, bool rotate, float db_scale, float2* s, int lane, int team,
    float* __restrict__ mag2 = nullptr) {
  using G = Geo<L>;
  constexpr int N = G::N, T = G::T, E = G::E, P = G::P;
  constexpr int R0 = G::R0, R1 = G::R1, Rl = G::Rl, Q0 = G::Q0;
  constexpr int kPs = G::kPadShift;
  float2 v[E];

  // ---- pass 0: device memory -> registers -> exchange buffer -------------
  // the derotator of sample c + Q0*j is exp(i*rot*c) * exp(i*rot*Q0)^j; the
  // sincosf calls come before the loads, while few registers are live
  float2 step = make_float2(1.0f, 0.0f), w0[E / R0];
#pragma unroll
  for (int a = 0; a < E / R0; ++a) w0[a] = make_float2(1.0f, 0.0f);
  if (rotate) {
    sincosf(rot * (float)Q0, &step.y, &step.x);
#pragma unroll
    for (int a = 0; a < E / R0; ++a)
      sincosf(rot * (float)(lane + T * a), &w0[a].y, &w0[a].x);
  }
#pragma unroll
  for (int a = 0; a < E / R0; ++a) {
#pragma unroll
    for (int j = 0; j < R0; ++j)
      v[a * R0 + j] = __ldg(win + lane + T * a + Q0 * j);
  }
  team_sync<T>(team);  // the previous window's readers are done with s
#pragma unroll
  for (int a = 0; a < E / R0; ++a) {
    const int c = lane + T * a;
    float2 w = w0[a];
#pragma unroll
    for (int j = 0; j < R0; ++j) {
      const int n = c + Q0 * j;
      float2 x = cmul(v[a * R0 + j], chirp[n]);
      if (rotate) {
        x = cmul(x, w);
        w = cmul(w, step);
      }
      v[a * R0 + j] = x;
    }
    fft_reg<R0>(v + a * R0);
#pragma unroll
    for (int m = 0; m < R0; ++m) {
      float2 x = v[a * R0 + brev<ilog2(R0)>(m)];
      if (m) x = cmul(x, tw[m * Q0 + c]);
      const int p = c + Q0 * m;
      s[p + (p >> kPs)] = x;
    }
  }
  team_sync<T>(team);

  // ---- middle pass (N = 2048, 4096): blocks of Q0 positions, in place ----
  if constexpr (P == 3) {
    constexpr int q = Q0 / R1;  // == Rl
#pragma unroll
    for (int a = 0; a < E / R1; ++a) {
      const int f = lane + T * a;
      const int i = f % q;
      const int base = (f / q) * Q0 + i;
#pragma unroll
      for (int j = 0; j < R1; ++j) {
        const int p = base + q * j;
        v[a * R1 + j] = s[p + (p >> kPs)];
      }
      fft_reg<R1>(v + a * R1);
#pragma unroll
      for (int m = 0; m < R1; ++m) {
        float2 x = v[a * R1 + brev<ilog2(R1)>(m)];
        if (m) x = cmul(x, tw[N + m * q + i]);
        const int p = base + q * m;
        s[p + (p >> kPs)] = x;
      }
    }
    team_sync<T>(team);
  }

  // ---- last pass: runs of Rl positions -> bins in registers --------------
#pragma unroll
  for (int a = 0; a < E / Rl; ++a) {
    const int p0 = (lane + T * a) * Rl;
#pragma unroll
    for (int j = 0; j < Rl; ++j) v[a * Rl + j] = s[p0 + (p0 >> kPs) + j];
    fft_reg<Rl>(v + a * Rl);
  }
  float* sf = reinterpret_cast<float*>(s);
  if (kMag2 && P == 3) team_sync<T>(team);  // s is free for the |X|^2

  // register (a, m) holds bin kb(f) + S*m of run f = lane + T*a
  constexpr int S = N / Rl;
  int kb[E / Rl];
#pragma unroll
  for (int a = 0; a < E / Rl; ++a) {
    const int f = lane + T * a;
    kb[a] = P == 2 ? f : f / R1 + R0 * (f % R1);
  }
  float pw[E];
  float best = -1.0f, sum = 0.0f;
  int bi = 0;
#pragma unroll
  for (int m = 0; m < Rl; ++m) {
#pragma unroll
    for (int a = 0; a < E / Rl; ++a) {
      const float2 x = v[a * Rl + brev<ilog2(Rl)>(m)];
      const float m2 = x.x * x.x + x.y * x.y;
      const int k = kb[a] + S * m;
      // with two passes a thread meets its bins in increasing order
      if (m2 > best || (P == 3 && m2 == best && k < bi)) {
        best = m2;
        bi = k;
      }
      sum += m2;
      pw[a * Rl + m] = m2;
      if (kMag2) {
        // two passes: consecutive lanes hold consecutive bins
        if (P == 2) mag2[k] = m2; else sf[k] = m2;
      }
    }
  }
  if (kMag2 && P == 3) {
    team_sync<T>(team);
    for (int k = lane; k < N; k += T) mag2[k] = sf[k];
  }

  // ---- the team's peak (lowest bin on ties) and total ---------------------
  const unsigned mask = team_mask<T>();
#pragma unroll
  for (int off = (T < 32 ? T : 32) / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(mask, best, off);
    const int oi = __shfl_xor_sync(mask, bi, off);
    sum += __shfl_xor_sync(mask, sum, off);
    if (ob > best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
  // the warps of a larger team meet in the words behind the padded window
  float* red = reinterpret_cast<float*>(s + G::kPadded);
  constexpr int nw = T / 32;
  if (T > 32) {
    if ((lane & 31) == 0) {
      red[lane >> 5] = best;
      red[4 + (lane >> 5)] = sum;
      red[8 + (lane >> 5)] = __int_as_float(bi);
    }
    team_sync<T>(team);
    best = red[0];
    sum = red[4];
    bi = __float_as_int(red[8]);
#pragma unroll
    for (int w = 1; w < nw; ++w) {
      const float ob = red[w];
      const int oi = __float_as_int(red[8 + w]);
      sum += red[4 + w];
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
  }

  DetectOut o;
  o.value = bi;
  const float fund = sqrtf(best);
  o.power = to_db(fund, db_scale);
  o.noise = to_db(sqrtf(fmaxf(sum - best, 0.0f)), db_scale);
  o.findex = 0.0f;
  if (kFindex) {
    // the peak's two neighbours: one register of one lane each
    const int kl = (bi - 1) & (N - 1), kr = (bi + 1) & (N - 1);
    float l = -1.0f, r = -1.0f;
#pragma unroll
    for (int m = 0; m < Rl; ++m) {
#pragma unroll
      for (int a = 0; a < E / Rl; ++a) {
        const int k = kb[a] + S * m;
        if (k == kl) l = pw[a * Rl + m];
        if (k == kr) r = pw[a * Rl + m];
      }
    }
#pragma unroll
    for (int off = (T < 32 ? T : 32) / 2; off > 0; off >>= 1) {
      l = fmaxf(l, __shfl_xor_sync(mask, l, off));
      r = fmaxf(r, __shfl_xor_sync(mask, r, off));
    }
    if (T > 32) {
      team_sync<T>(team);  // every thread has read the peak's words
      if ((lane & 31) == 0) {
        red[lane >> 5] = l;
        red[4 + (lane >> 5)] = r;
      }
      team_sync<T>(team);
#pragma unroll
      for (int w = 0; w < nw; ++w) {
        l = fmaxf(l, red[w]);
        r = fmaxf(r, red[4 + w]);
      }
    }
    const float left = sqrtf(l), right = sqrtf(r);
    const float denom = 2.0f * fund - right - left;
    o.findex = denom == 0.0f ? 0.0f : 0.5f * (right - left) / denom;
  }
  return o;
}

// What a launch asks the runtime about one kernel on one device, asked once:
// a launch function keeps a static Resident per kernel instantiation, so the
// attribute and occupancy calls stay off the path of every later launch.
struct Resident {
  static constexpr int kDevices = 64;
  std::atomic<int> fit[kDevices];  // blocks the device holds at once; 0: not asked
};

// Blocks of `kernel` that the current device holds at once at this block
// size and dynamic shared memory (always the same two for one kernel).  The
// first call on a device also opts the kernel in to more than 48 KB of
// dynamic shared memory, which needs an explicit attribute.
template <typename K>
inline cudaError_t resident_blocks(K kernel, int threads, size_t smem,
                                   Resident& cache, long long* fit) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < Resident::kDevices;
  if (cached) {
    *fit = cache.fit[dev].load(std::memory_order_relaxed);
    if (*fit > 0) return cudaSuccess;
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *fit = (long long)sms * per_sm;
  if (cached) cache.fit[dev].store((int)*fit, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace lora

// `return fn<log2 N>(args...);` for N in 64..4096.
#define LORA_FOR_WINDOW_SIZE(N, fn, ...)                 \
  switch (N) {                                           \
    case 64: return fn<6>(__VA_ARGS__);                  \
    case 128: return fn<7>(__VA_ARGS__);                 \
    case 256: return fn<8>(__VA_ARGS__);                 \
    case 512: return fn<9>(__VA_ARGS__);                 \
    case 1024: return fn<10>(__VA_ARGS__);               \
    case 2048: return fn<11>(__VA_ARGS__);               \
    case 4096: return fn<12>(__VA_ARGS__);               \
    default: return (int)cudaErrorInvalidValue;          \
  }
