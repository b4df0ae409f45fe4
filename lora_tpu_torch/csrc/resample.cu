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
// each output written once, 8 a complex64 sample (4 * taps float32
// operations an output, 56 at the decimation by 8/5, are far below the
// float32 rate).  Two routes, two kernels of one name, chosen on the host
// from the plan table it builds (ops/cuda_resample.py `runs`):
//
// The general route (`resample_kernel`), any plan.  A block takes a tile of
// `tile` consecutive outputs over kResRows rows: it puts the tile's plan in
// shared memory once, then for each row stages the tile's input span (at
// most `span` samples: the tile's outputs at `ratio` inputs apart and the
// taps past the last) in shared memory with coalesced loads; consecutive
// threads then take consecutive outputs, each reading its taps from shared
// memory and its weights by __ldg, and store them coalesced.  Its pace is
// set by that data path, not by the bytes: at 8/5, 14 reads of shared
// memory an output, whose warp spans about 51 words (1.6 inputs between
// lanes), and 14 weights from five phases, about six L1/shared wavefronts
// a warp a tap; 0.9 G a call at the US902-928 cell's shape, which at one a
// clock on 132 SMs is its 3.55 to 3.6 ms (58% of the 2.083-ms bound by
// bytes).  Tried against it in one call each, none faster: the rows' spans
// copied ahead by cp.async into two buffers 3.78 ms; lanes over 32 rows
// with a warp an output, spans at odd pitches (no bank conflict) 3.91 ms;
// the bank in shared memory 3.565 ms (0.7% faster).
//
// The register-blocked route (`resample_kernel<P, Q, TAPS>`), a plan
// that repeats every P outputs and Q inputs (8/5: 5 and 8) at one of the
// instances below.  Consecutive outputs share most of their taps (at 8/5,
// 27 inputs feed 8 outputs, not 112), so a thread takes a run of RUN
// periods of one row, RUN * P consecutive outputs starting at an output of
// phase 0, loads the run's window of inputs once from shared memory into
// registers (16-byte loads) and forms every output from registers, with
// the weights of the period's P subfilters as kernel parameters (the
// constant bank: every lane of the launch reads the same weight at the
// same step).  Every run has the same offsets inside its window (the
// plan's, `off` below, in exact arithmetic, which the host checks against
// the table) and the same phases, so every index into the window is a
// literal.  A warp takes 32 consecutive runs of one row: it copies their
// span ahead by cp.async into one of two buffers while it computes from
// the other, laid out with PAD samples after each run's IN inputs so that
// the lanes' 16-byte reads fall in eight distinct bank quads; it stages its
// outputs through shared memory and stores them coalesced.  Warps walk the
// (row, 32 runs) tiles of the launch in turn, as many as the card holds at
// once.  The outputs before the first of phase 0 and after the last whole
// run (at most P - 1 + RUN * P - 1 a row) are formed straight from device
// memory, an output a lane, in the same launch.  Shared and L1 traffic
// falls from about six wavefronts a warp a tap to about 0.5 a warp an
// output, and the bytes are left to bound it: 2.43 ms at the cell's shape
// (86% of the 2.083-ms bound), where torch's own copies of those bytes
// (2.92 to 2.98 TB/s) would take 2.34 to 2.43 ms.  Tried against it in one
// call each, none apart from it by more than a call's noise (about 1.5%):
// its span staged just before use, not ahead; runs of one period (92
// registers); three buffers, the outputs staged in the one read; streaming
// stores; fewer integer operations a tile.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lora {

constexpr int kResThreads = 256;
constexpr int kResRows = 8;    // rows a block of the general route walks
constexpr int kResUnroll = 4;  // loads a thread has in flight while staging
constexpr int kNPhase = 128;   // ops/tables.py RESAMPLE_PHASES
constexpr int kResWarps = kResThreads / 32;

// The register-blocked route's geometry: a plan of period P outputs over Q
// inputs, TAPS taps, RUN periods a thread (ops/cuda_resample.py `offsets`
// and `blocked_smem` give the same numbers).
template <int P, int Q, int TAPS>
struct Runs {
  static constexpr int RUN = 2;
  // output i's first input past that of the period's output of phase 0, as
  // ops/resample.py `_plan` places it: the position's integer part, one
  // more where its fraction rounds to a phase above 0
  __host__ __device__ static constexpr int off(int i) {
    return (i * Q) / P + ((2 * ((i * Q) % P) * kNPhase + P) / (2 * P) > 0);
  }
  static constexpr int OUT = RUN * P;   // outputs a run
  static constexpr int IN = RUN * Q;    // inputs from one run to the next
  static constexpr int WIN = (RUN - 1) * Q + off(P - 1) + TAPS;  // a run's
  static constexpr int PAD = IN % 4 == 0 ? 2 : 0;  // pitch / 2 odd
  static constexpr int PITCH = IN + PAD;
  static constexpr int SPAN = 31 * IN + WIN;  // inputs of a warp's 32 runs
  // a buffer: the span at its pitch, past it the second half of the last
  // 16-byte read of an odd window, rounded up to 16 bytes
  static constexpr int IBUF = (SPAN + PAD * (SPAN / IN) + 3) & ~1;
  static constexpr int OPITCH = OUT | 1;  // odd: no bank conflict
  static constexpr int OBUF = (32 * OPITCH + 1) & ~1;
  static constexpr int WARP = 2 * IBUF + OBUF;  // float2 a warp
  static constexpr size_t SMEM = (size_t)kResWarps * WARP * 8;
  static_assert(IN % 2 == 0, "runs start on 16-byte boundaries");
  static_assert(P - 1 + OUT - 1 <= 32, "a row's edge outputs fit a warp");
  static_assert(SMEM <= 232448, "shared memory of a block");

  __device__ static constexpr int addr(int u) { return u + PAD * (u / IN); }
};

template <int N>
struct Weights {
  float w[N];
};

__device__ __forceinline__ long long clamp_index(long long g, long long T) {
  return g < 0 ? 0 : (g > T - 1 ? T - 1 : g);
}

// The general route: see the note above.
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

// The register-blocked route: see the note above.  align: the table's
// first output of phase 0; wt: the weights of the period's outputs from
// there, [P, TAPS].
template <int P, int Q, int TAPS>
__global__ void __launch_bounds__(kResThreads, 2)
resample_kernel(const float2* __restrict__ x, long long rows, long long T,
                long long row_stride, long long col_stride,
                const int* __restrict__ plan, long long M,
                const float* __restrict__ bank, int align,
                const Weights<P * TAPS> wt, float2* __restrict__ out) {
  using G = Runs<P, Q, TAPS>;
  extern __shared__ float4 res_smem4[];
  const int lane = threadIdx.x & 31;
  float2* ib0 = reinterpret_cast<float2*>(res_smem4) +
                (threadIdx.x >> 5) * G::WARP;
  float2* ob = ib0 + 2 * G::IBUF;
  const long long gw = ((long long)blockIdx.x * kResThreads + threadIdx.x) >> 5;
  const long long nw = ((long long)gridDim.x * kResThreads) >> 5;
  const long long nruns = (M - align) / G::OUT;
  const long long ntw = (nruns + 31) / 32;  // a row's tiles of 32 runs
  const long long tail0 = align + nruns * G::OUT;
  const int nedge = align + (int)(M - tail0);

  // the edges, an output a lane, straight from device memory
  if (nedge > 0) {
    for (long long r = gw; r < rows; r += nw) {
      if (lane >= nedge) continue;
      const long long m = lane < align ? lane : tail0 + (lane - align);
      const float2* xr = x + r * row_stride;
      const long long s = plan[m];
      const float* w = bank + (long long)plan[M + m] * TAPS;
      float2 v = __ldg(xr + clamp_index(s, T) * col_stride);
      float wj = __ldg(w);
      float ar = __fmul_rn(v.x, wj), ai = __fmul_rn(v.y, wj);
#pragma unroll
      for (int j = 1; j < TAPS; ++j) {
        v = __ldg(xr + clamp_index(s + j, T) * col_stride);
        wj = __ldg(w + j);
        ar = __fadd_rn(ar, __fmul_rn(v.x, wj));
        ai = __fadd_rn(ai, __fmul_rn(v.y, wj));
      }
      out[r * M + m] = make_float2(ar, ai);
    }
  }

  const long long items = rows * ntw;
  const long long s_a = plan[align];  // the first aligned output's input
  // start the copy of tile `it`'s span (row it / ntw) into `buf`, past the
  // registers
  auto stage = [&](long long it, float2* buf) {
    const long long r = it / ntw;
    const float2* xr = x + r * row_stride;
    const long long s0 = s_a + (it - r * ntw) * 32 * G::IN;
#pragma unroll
    for (int k = 0; k < (G::SPAN + 31) / 32; ++k) {
      const int u = lane + 32 * k;
      if (u < G::SPAN)
        __pipeline_memcpy_async(buf + G::addr(u),
                                xr + clamp_index(s0 + u, T) * col_stride,
                                sizeof(float2));
    }
  };

  int k = 0;
  if (gw < items) stage(gw, ib0);
  __pipeline_commit();
  for (long long it = gw; it < items; it += nw, k ^= 1) {
    if (it + nw < items) stage(it + nw, ib0 + (k ^ 1) * G::IBUF);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this tile's span is in
    __syncwarp();
    const long long r = it / ntw;
    const long long j0 = (it - r * ntw) * 32;  // the tile's first run
    if (j0 + lane < nruns) {
      const float2* v = ib0 + k * G::IBUF + lane * G::PITCH;
      float2 win[G::WIN + 1];
#pragma unroll
      for (int q = 0; q < G::WIN; q += 2) {
        const float4 f = *reinterpret_cast<const float4*>(v + G::addr(q));
        win[q] = make_float2(f.x, f.y);
        win[q + 1] = make_float2(f.z, f.w);
      }
      float2* o = ob + lane * G::OPITCH;
#pragma unroll
      for (int rr = 0; rr < G::RUN; ++rr) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float2* xi = win + rr * Q + G::off(i);
          const float* w = wt.w + i * TAPS;
          float ar = __fmul_rn(xi[0].x, w[0]), ai = __fmul_rn(xi[0].y, w[0]);
#pragma unroll
          for (int j = 1; j < TAPS; ++j) {
            ar = __fadd_rn(ar, __fmul_rn(xi[j].x, w[j]));
            ai = __fadd_rn(ai, __fmul_rn(xi[j].y, w[j]));
          }
          o[rr * P + i] = make_float2(ar, ai);
        }
      }
    }
    __syncwarp();
    const long long left = (nruns - j0) * G::OUT;
    const int n = (int)(left < 32 * G::OUT ? left : 32 * G::OUT);
    float2* orow = out + r * M + align + j0 * G::OUT;
#pragma unroll
    for (int q = 0; q < G::OUT; ++q) {
      const int o = lane + 32 * q;
      if (o < n) orow[o] = ob[(o / G::OUT) * G::OPITCH + o % G::OUT];
    }
    __syncwarp();  // the buffers are read before the next copies land
  }
  __pipeline_wait_prior(0);
}

template <int P, int Q, int TAPS>
int launch_blocked(const float2* x, long long rows, long long T,
                   long long row_stride, long long col_stride,
                   const int* plan, long long M, const float* bank, int align,
                   const float* wts, size_t smem, float2* out,
                   cudaStream_t stream) {
  using G = Runs<P, Q, TAPS>;
  if (smem != G::SMEM || align < 0 || align >= P || M <= align)
    return (int)cudaErrorInvalidValue;
  Weights<P * TAPS> wt;
  for (int i = 0; i < P * TAPS; ++i) wt.w[i] = wts[i];
  auto kern = resample_kernel<P, Q, TAPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as the card holds at once (its launch queries, once)
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, kern, kResThreads, G::SMEM)) != cudaSuccess)
      return (int)err;
    resident = sms * (per > 0 ? per : 1);
  }
  const long long nruns = (M - align) / G::OUT;
  const long long items = rows * ((nruns + 31) / 32);
  long long blocks = ((items > rows ? items : rows) + kResWarps - 1) /
                     kResWarps;
  blocks = blocks < resident ? blocks : resident;
  resample_kernel<P, Q, TAPS><<<(unsigned)blocks, kResThreads, G::SMEM,
                                stream>>>(
      x, rows, T, row_stride, col_stride, plan, M, bank, align, wt, out);
  return (int)cudaGetLastError();
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
  // the general route's kernel among the overloads of its name
  void (*const general)(const float2*, long long, long long, long long,
                        long long, const int*, long long, int, const float*,
                        int, float2*) = resample_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        general, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long tiles = (M + tile - 1) / tile;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  long long by = (rows + kResRows - 1) / kResRows;
  by = by < 65535 ? by : 65535;
  const dim3 grid((unsigned)tiles, (unsigned)by);
  general<<<grid, kResThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(x), rows, T, row_stride, col_stride,
      static_cast<const int*>(plan), M, taps,
      static_cast<const float*>(bank), tile, static_cast<float2*>(out));
  return (int)cudaGetLastError();
}

// The register-blocked route: x, plan, bank and out as lora_resample's; the
// plan repeats every P outputs and Q inputs with the offsets of `Runs::off`
// from its output `align` (< P), the first of phase 0
// (ops/cuda_resample.py `runs` checks the table); wts: on the host, the
// float32 weights [P, taps] of outputs align .. align + P - 1; smem: the
// bytes of a block (ops/cuda_resample.py `blocked_smem`), checked against
// the instance's.  An instance not built here returns
// cudaErrorInvalidValue.  Returns a CUDA error code.
extern "C" int lora_resample_blocked(const void* x, long long rows,
                                     long long T, long long row_stride,
                                     long long col_stride, const void* plan,
                                     long long M, int taps, const void* bank,
                                     int P, int Q, int align, const void* wts,
                                     long long smem, void* out,
                                     void* stream) {
  using namespace lora;
  if (rows == 0 || M == 0) return 0;
  if (T < 1) return (int)cudaErrorInvalidValue;
  const auto xs = static_cast<const float2*>(x);
  const auto pl = static_cast<const int*>(plan);
  const auto bk = static_cast<const float*>(bank);
  const auto w = static_cast<const float*>(wts);
  const auto o = static_cast<float2*>(out);
  const auto st = (cudaStream_t)stream;
  // the instances: 8/5 (a 200-kHz slot to 125 kHz, 14 taps) and 5/8 (back)
  if (P == 5 && Q == 8 && taps == 14)
    return launch_blocked<5, 8, 14>(xs, rows, T, row_stride, col_stride, pl,
                                    M, bk, align, w, (size_t)smem, o, st);
  if (P == 8 && Q == 5 && taps == 8)
    return launch_blocked<8, 5, 8>(xs, rows, T, row_stride, col_stride, pl,
                                   M, bk, align, w, (size_t)smem, o, st);
  return (int)cudaErrorInvalidValue;
}
