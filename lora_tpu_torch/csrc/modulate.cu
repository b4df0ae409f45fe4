// Kernel F: a bank of LoRa frames synthesised in one pass.
//
// Replaces XLA's fusion of lora_tpu/models/modulator.py:72 (`modulate`,
// one jitted program; there is no pallas_call).  Row b of the output
// [B, T] is the frame of the symbols syms[b, :S]: the head (preamble, sync
// word, 2.25 downchirps; the same for every row, made once per config by
// the plain ops and passed in), then S data upchirps, then the zero
// padding.  Each sample is written exactly once.
//
// Phase arithmetic (ops/chirp.py): sample i of a data symbol s has the
// phase numerator
//
//   num = (i1*A + tri(i1) + w*wrap + start) & (D - 1),   i1 = i + 1,
//   A = s*ovs + (2D - N*ovs/2) % D,  tri(i1) = (i1*(i1+1) mod 2D) / 2,
//   w = max(0, i1 + 1 - ovs*(N - s)),  wrap = (D - N*ovs % D) % D,
//
// of D = N*ovs^2, a power of two that divides 2^32, so every sum and
// product is taken in uint32 and wraps, as lora_tpu's own uint32 sums do
// (lora_tpu/models/modulator.py:96-98).  `start` is the symbol's phase
// continuity: the head's end carry plus the end carries (num at i1 = NN) of
// the row's earlier symbols.  Each block forms its row's carries and their
// exclusive prefix sum in shared memory, so the whole bank is one launch.
//
// Float32 sequence, that of the plain route (cplx.from_turns) step by
// step: float(num) / D (exact: a product by 1/D, D a power of two), times
// float32(2 pi), the full-precision cosf and sinf (the build has no
// --use_fast_math), times float32(ampl).  No add follows a product, so
// nothing contracts to an fma.
//
// What bounds it on the H100: the bytes written, 8 a sample, and the
// cosf/sinf pair of each data sample.  A block writes kModChunks runs of
// kModItems * kModThreads consecutive samples of one row, after one
// prologue that puts the row's per-symbol terms in shared memory (a
// symbol spans at least 128 samples, so a warp reads one or two of them).
// Consecutive threads take consecutive samples, so the stores coalesce
// (streaming stores: the bank is written once and read by later kernels,
// not by this one), and a thread's kModItems samples are independent, so
// their transcendentals overlap.  The division by D is a product by its
// reciprocal, exact for a power of two.

#include <cuda_runtime.h>
#include <stdint.h>

namespace lora {

constexpr int kModThreads = 256;
constexpr int kModItems = 8;
constexpr int kModChunks = 4;
constexpr int kModWarps = kModThreads / 32;
// symbols a row may hold: four 4-byte terms of each in shared memory,
// within the 227 KB a block can opt in to
constexpr int kMaxSymbols = 14336;

struct Chirp {
  unsigned N, ovs, NN, D, a0, wrap;
};

// The terms of a symbol s that its samples share: A = s*ovs + a0, the
// wrap's threshold thr = ovs*(N - s) (its sample i1 wraps where i1 + 1 >
// thr) clamped to [0, NN + 2], which keeps that test for every i1 in
// [1, NN], and c = -thr * wrap, so that w*wrap = (i1 + 1)*wrap + c where
// w = i1 + 1 - thr > 0 (mod 2^32).
struct Sym {
  unsigned A, c;
  int thr;
};

__device__ __forceinline__ Sym sym_terms(const Chirp& k, int s) {
  const long long thr = (long long)k.ovs * ((long long)k.N - s);
  Sym r;
  r.A = (unsigned)s * k.ovs + k.a0;
  r.c = (unsigned)(-thr) * k.wrap;
  r.thr = (int)(thr < 0 ? 0 : (thr > k.NN + 2 ? k.NN + 2 : thr));
  return r;
}

// The phase numerator of sample i1 - 1 of a symbol, before its start and
// the reduction mod D.
__device__ __forceinline__ unsigned phase_num(const Chirp& k, unsigned A,
                                              unsigned c, int thr,
                                              unsigned i1) {
  const unsigned tri = ((i1 * (i1 + 1u)) & (2u * k.D - 1u)) >> 1;
  const unsigned wrapped =
      (int)(i1 + 1u) > thr ? (i1 + 1u) * k.wrap + c : 0u;
  return i1 * A + tri + wrapped;
}

__device__ __forceinline__ unsigned warp_inclusive_sum(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__global__ void __launch_bounds__(kModThreads)
modulate_kernel(const int* __restrict__ syms, long long B, int S,
                const float2* __restrict__ head, int H, unsigned head_carry,
                Chirp k, long long T, float inv_d, float two_pi, float ampl,
                float2* __restrict__ out) {
  extern __shared__ unsigned smem[];
  unsigned* sA = smem;                            // [S]
  unsigned* sC = smem + S;                        // [S]
  int* sThr = reinterpret_cast<int*>(smem + 2 * S);  // [S]
  unsigned* sStart = smem + 3 * S;                // [S]
  __shared__ unsigned wsum[kModWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int log2nn = __ffs((int)k.NN) - 1;
  const long long data_end = (long long)H + (long long)S * k.NN;
  constexpr int kChunk = kModThreads * kModItems;
  const long long base = (long long)blockIdx.x * (kChunk * kModChunks);
  const int per = (S + kModThreads - 1) / kModThreads;
  const int lo = min(S, (int)threadIdx.x * per), hi = min(S, lo + per);

  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    // the row's symbol terms, their end carries (num at i1 = NN) and the
    // exclusive prefix sum of the carries after the head's: each thread a
    // run of `per` symbols
    const int* row = syms + b * S;
    unsigned local = 0;
    for (int j = lo; j < hi; ++j) {
      const Sym t = sym_terms(k, __ldg(row + j));
      const unsigned carry = phase_num(k, t.A, t.c, t.thr, k.NN) & (k.D - 1u);
      sA[j] = t.A;
      sC[j] = t.c;
      sThr[j] = t.thr;
      sStart[j] = carry;
      local += carry;
    }
    const unsigned incl = warp_inclusive_sum(local);
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      unsigned v = lane < kModWarps ? wsum[lane] : 0u;
      v = warp_inclusive_sum(v);
      if (lane < kModWarps) wsum[lane] = v;
    }
    __syncthreads();
    unsigned run = head_carry + (warp ? wsum[warp - 1] : 0u) + incl - local;
    for (int j = lo; j < hi; ++j) {
      const unsigned carry = sStart[j];
      sStart[j] = run & (k.D - 1u);
      run += carry;
    }
    __syncthreads();

    float2* orow = out + b * T;
    for (int r = 0; r < kModChunks; ++r) {
#pragma unroll
      for (int i = 0; i < kModItems; ++i) {
        const long long t = base + (long long)r * kChunk +
                            (long long)i * kModThreads + threadIdx.x;
        if (t < T) {
          float2 v = make_float2(0.f, 0.f);
          if (t < H) {
            v = __ldg(head + t);
          } else if (t < data_end) {
            const unsigned d = (unsigned)(t - H);
            const int j = (int)(d >> log2nn);
            const unsigned i1 = (d & (k.NN - 1u)) + 1u;
            const unsigned num =
                (phase_num(k, sA[j], sC[j], sThr[j], i1) + sStart[j]) &
                (k.D - 1u);
            const float ang = __fmul_rn(__uint2float_rn(num), inv_d) * two_pi;
            v = make_float2(cosf(ang) * ampl, sinf(ang) * ampl);
          }
          __stcs(orow + t, v);
        }
      }
    }
    __syncthreads();  // the next row overwrites the symbols' terms
  }
}

}  // namespace lora

// syms: int32 [B, S] contiguous, the data symbols; head: complex64 [H], the
// frame's head (head_carry its end carry, in [0, D)); out: complex64 [B, T]
// contiguous with T = H + (S + padding) * N * ovs, which the caller
// computes.  N and ovs are powers of two with D = N*ovs^2 <= 2^30, two_pi
// and ampl the float32 constants of the plain route.  Returns a CUDA error
// code (cudaErrorInvalidValue for S above kMaxSymbols).
extern "C" int lora_modulate(const void* syms, long long B, int S,
                             const void* head, int H, int head_carry, int N,
                             int ovs, long long T, float two_pi, float ampl,
                             void* out, void* stream) {
  using namespace lora;
  if (B == 0 || T == 0) return 0;
  if (S < 0 || S > kMaxSymbols) return (int)cudaErrorInvalidValue;
  Chirp k;
  k.N = (unsigned)N;
  k.ovs = (unsigned)ovs;
  k.NN = (unsigned)(N * ovs);
  k.D = k.NN * (unsigned)ovs;
  k.a0 = (2u * k.D - k.N * k.ovs / 2u) % k.D;
  k.wrap = (k.D - k.N * k.ovs % k.D) % k.D;
  const size_t smem = (size_t)S * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        modulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long span = (long long)kModThreads * kModItems * kModChunks;
  const long long blocks = (T + span - 1) / span;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)(B < 65535 ? B : 65535));
  modulate_kernel<<<grid, kModThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(syms), B, S, static_cast<const float2*>(head),
      H, (unsigned)head_carry, k, T, 1.0f / (float)k.D, two_pi, ampl,
      static_cast<float2*>(out));
  return (int)cudaGetLastError();
}
