// Shared dechirp -> DFT -> peak routine of the three Hopper kernels
// (detect.cu, track.cu, payload.cu), as the JAX package's fused kernels
// share `direct_vals` / `four_step_vals` (lora_tpu/ops/pallas_detect.py).
//
// A "team" of tpw = team_threads(N) threads (N/16, clamped to [32, 256])
// owns one window of N samples (N a power of two, 64..4096).  The team dechirps (and optionally
// derotates) the window while loading it into shared memory, transforms it
// in place over a table of twiddles, then reduces |X|^2 to the peak bin
// (lowest index on ties), the peak and residual powers in dB and the
// 3-point fractional bin, with the arithmetic of
// lora_tpu/ops/detect.py:64-91.  Every thread of the block calls
// detect_window together: the routine synchronises the whole block.
//
// Built without --use_fast_math: sincosf, log10f and sqrtf are the full
// precision functions, so the dB values and the derotation follow the plain
// PyTorch version (ops/detect.py) to float32 rounding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lora {

constexpr int kMaxTeamThreads = 256;
constexpr int kMaxWarps = 32;

struct DetectOut {
  int value;
  float power;
  float noise;
  float findex;
};

struct DetectConsts {
  const float2* chirp;  // dechirp table [N]
  const float2* tw;     // exp(-2*pi*i*k/N), k < N/2
  int N;
  int log2n;
  float rot_scale;  // float32(-2*pi/N): derotation angle = (rot_scale*fe)*n
  float db_scale;   // float32(20*log10(N))
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 mul_neg_i(float2 a) {  // a * (-i)
  return make_float2(a.y, -a.x);
}

// bit reversal over log2n bits: the bin held at FFT position p, and the
// position that holds bin k (the map is its own inverse)
__device__ __forceinline__ int bin_of(int p, int log2n) {
  return (int)(__brev((unsigned)p) >> (32 - log2n));
}

// Two radix-2 DIF stages on v[0..3] = elements i, i+q, i+2q, i+3q of a
// block of length L = 4q: w1 = W_L^i, w2 = W_{L/2}^i, and
// W_L^(i+q) = -i * W_L^i.  kTwiddle=false is the last pass (i = 0, unit
// twiddles, no multiplies).
template <bool kTwiddle>
__device__ __forceinline__ void dif4(float2 (&v)[4], float2 w1, float2 w2) {
  const float2 b0 = cadd(v[0], v[2]), b1 = cadd(v[1], v[3]);
  float2 b2 = csub(v[0], v[2]);
  float2 b3 = mul_neg_i(csub(v[1], v[3]));
  if (kTwiddle) {
    b2 = cmul(b2, w1);
    b3 = cmul(b3, w1);
  }
  v[0] = cadd(b0, b1);
  v[1] = csub(b0, b1);
  v[2] = cadd(b2, b3);
  v[3] = csub(b2, b3);
  if (kTwiddle) {
    v[1] = cmul(v[1], w2);
    v[3] = cmul(v[3], w2);
  }
}

// One float2 of padding after every 16 spreads the strided accesses of
// the late passes over more shared-memory banks.
__device__ __forceinline__ int pad(int p) { return p + (p >> 4); }

__device__ __forceinline__ float to_db(float a, float scale) {
  return 20.0f * log10f(fmaxf(a, 1e-20f)) - scale;
}

// Detect the window `win` (N samples, any alignment) with the team of
// threads `lane` = 0..tpw-1, working in the team's shared buffer s
// (team_smem(N) float2).
// rotate=false skips the derotation (the coarse search has no fine CFO).
template <bool kFindex>
__device__ DetectOut detect_window(const float2* __restrict__ win,
                                   const DetectConsts& c, float fe,
                                   bool rotate, float2* s, int lane,
                                   int tpw) {
  __shared__ float red_best[kMaxWarps];
  __shared__ float red_sum[kMaxWarps];
  __shared__ int red_idx[kMaxWarps];
  const int N = c.N;

  __syncthreads();  // the previous window's readers are done with s
  const float a = c.rot_scale * fe;

  // Decimation in frequency over the padded shared buffer, natural order
  // in and bit-reversed order out (position p holds X[bitrev(p)]).  Each
  // pass fuses two radix-2 stages ("radix-2^2", block lengths L and L/2):
  // a thread takes the elements i, i+q, i+2q, i+3q (q = L/4) of one block
  // through both stages in registers.  The first pass reads the window
  // straight from device memory (dechirp and derotation on the way in),
  // and the last one feeds the peak search from registers.
  const int q0 = N >> 2;
  for (int g = lane; g < q0; g += tpw) {
    float2 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = g + j * q0;
      v[j] = cmul(__ldg(win + n), __ldg(c.chirp + n));
      if (rotate) {
        float sn, cs;
        sincosf(a * (float)n, &sn, &cs);
        v[j] = cmul(v[j], make_float2(cs, sn));
      }
    }
    dif4<true>(v, __ldg(c.tw + g), __ldg(c.tw + 2 * g));
#pragma unroll
    for (int j = 0; j < 4; ++j) s[pad(g + j * q0)] = v[j];
  }
  __syncthreads();

  int L = N >> 2;
  for (int stride = 4; L > 4; L >>= 2, stride <<= 2) {
    const int q = L >> 2;
    for (int g = lane; g < q0; g += tpw) {
      const int i = g & (q - 1);
      const int p0 = ((g - i) << 2) + i;
      float2 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = s[pad(p0 + j * q)];
      dif4<true>(v, __ldg(c.tw + i * stride), __ldg(c.tw + 2 * i * stride));
#pragma unroll
      for (int j = 0; j < 4; ++j) s[pad(p0 + j * q)] = v[j];
    }
    __syncthreads();
  }

  // last pass (L = 4: radix-2^2 with unit twiddles; L = 2 when log2(N) is
  // odd: one radix-2 stage) fused with the peak (lowest bin on ties) and
  // total of |X|^2; the spectrum goes back to shared memory only for the
  // fractional bin's neighbours
  float best = -1.0f, sum = 0.0f;
  int bi = 0;
  auto visit = [&](int p, float2 v) {
    const float m2 = v.x * v.x + v.y * v.y;
    const int k = bin_of(p, c.log2n);
    if (m2 > best || (m2 == best && k < bi)) {
      best = m2;
      bi = k;
    }
    sum += m2;
    if (kFindex) s[pad(p)] = v;
  };
  if (L == 4) {
    for (int g = lane; g < q0; g += tpw) {
      float2 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = s[pad(4 * g + j)];
      dif4<false>(v, make_float2(1.0f, 0.0f), make_float2(1.0f, 0.0f));
#pragma unroll
      for (int j = 0; j < 4; ++j) visit(4 * g + j, v[j]);
    }
  } else {
    for (int g = lane; g < (N >> 1); g += tpw) {
      const float2 u = s[pad(2 * g)], w = s[pad(2 * g + 1)];
      visit(2 * g, cadd(u, w));
      visit(2 * g + 1, csub(u, w));
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (ob > best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red_best[warp] = best;
    red_sum[warp] = sum;
    red_idx[warp] = bi;
  }
  __syncthreads();
  // every thread of the team folds its team's warps in the same order
  const int w0 = (threadIdx.x - lane) >> 5;
  const int nw = tpw >> 5;
  best = red_best[w0];
  sum = red_sum[w0];
  bi = red_idx[w0];
  for (int w = 1; w < nw; ++w) {
    const float ob = red_best[w0 + w];
    const int oi = red_idx[w0 + w];
    sum += red_sum[w0 + w];
    if (ob > best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }

  DetectOut o;
  o.value = bi;
  const float fund = sqrtf(best);
  o.power = to_db(fund, c.db_scale);
  o.noise = to_db(sqrtf(fmaxf(sum - best, 0.0f)), c.db_scale);
  o.findex = 0.0f;
  if (kFindex) {
    const float2 l = s[pad(bin_of((bi - 1) & (N - 1), c.log2n))];
    const float2 r = s[pad(bin_of((bi + 1) & (N - 1), c.log2n))];
    const float left = sqrtf(l.x * l.x + l.y * l.y);
    const float right = sqrtf(r.x * r.x + r.y * r.y);
    const float denom = 2.0f * fund - right - left;
    o.findex = denom == 0.0f ? 0.0f : 0.5f * (right - left) / denom;
  }
  return o;
}

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// float2 elements of one team's padded shared buffer
__host__ __device__ inline int team_smem(int N) { return N + (N >> 4); }

// Samples per team thread: a team has N / kTeamElems threads, clamped to
// one to eight warps.  16 (64 threads at N = 1024, four windows in a block
// of 256) beat 2, 4 and 8 on the H100 (PERF.md).
constexpr int kTeamElems = 16;

__host__ __device__ inline int team_threads(int N) {
  const int t = N / kTeamElems;
  return t < 32 ? 32 : (t < kMaxTeamThreads ? t : kMaxTeamThreads);
}

}  // namespace lora
