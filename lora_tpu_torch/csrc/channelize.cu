// Kernel D: polyphase analysis filterbank, wideband -> K channels.
//
// Replaces both filterbank kernels of lora_tpu/ops/pallas_channelize.py:
// _filterbank_fir (pallas_call at :376, the factorized FIR + IDFT form with
// channel-major output) and _filterbank (pallas_call at :187, the dense
// block-Toeplitz product y = z0*W1 + z1*W2 with channel-minor output).  The
// two exist to fit the TPU's lanes and VMEM; this kernel computes the
// factorized form for any K and L whose tile fits shared memory:
//
//   u[m, q] = sum_l hp[l, q] * x2[m + L-1-l, q]          per-lane FIR
//   y[k, m] = sum_q u[m, q] * W[((K-1-q) * k) mod K]     K-point IDFT
//
// with x2[r, q] = xp[r*K + q] the (rows, K) view of the state-prepended
// stream, hp the taps with the commutator's lane flip folded in
// (tables.fir_taps_flipped) and W the K-entry table e^{+2 pi i j/K}, rounded
// from float64 as tables.idft_k rounds it.  The caller concatenates
// state ++ x before the launch (one extra pass, as the JAX package does), so
// the kernel reads one stream pointer with a row stride.  The output is
// channel-major complex64 [S, K, M], contiguous, so that reshape(S*K, M) is
// the demod bank with no copy.
//
// What bounds it on the H100: per output sample the FIR costs 4L flop and
// the IDFT 8K (544 flop at K = 64, L = 8), while the sample moves 16 bytes
// (8 in, 8 out).  At the config-3 bank (256 streams x 64 channels x 10,240
// samples) that is 91 GFLOP against 2.7 GB: about 1.4 ms at the 67 TFLOP/s
// float32 rate and 0.8 ms at 3.35 TB/s.  This direct sum is therefore bound by
// its float32 arithmetic (the function itself is not: a fast K-point transform
// needs about 5 log2 K = 30 flop per sample, which leaves the 0.8 ms of
// traffic as the bound), and the design feeds the FMA pipes: each thread
// keeps a register tile of kKB channels x kMB samples, so one u value loaded
// from shared memory serves kKB complex multiply-adds and one twiddle serves
// kMB; the twiddle index steps by -k per q with one conditional wrap, no
// integer division.  The dense form (about 8*(L+G-1)*K flop per sample, 14x
// more at G = 8) is the plain version's matrix product, not this kernel's.
//
// Block: one (stream, tile of TM output samples).  It stages the TM + L - 1
// rows of K samples it needs into shared memory (row stride K + 1 against
// bank conflicts; rows past the stream's M + L - 1 read as zero), runs the
// FIR into u[K][TM], then the IDFT with threads mapped to m, so each channel
// row's stores are coalesced.  Outputs past M are masked.  TM is chosen per
// (K, L) here, in lora_channelize_tile, which the wrapper
// (ops/cuda_channelize.py) also asks so that a width with no tile raises
// ValueError before the launch; wgmma and TMA are for a later version.

#include <cuda_runtime.h>

namespace lora {

constexpr int kThreads = 256;
constexpr int kMB = 2;  // output samples per thread
constexpr int kKB = 8;  // channels per thread
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory per block, sm_90

// Shared memory of one tile: the K-entry twiddle table, TM + L - 1 staged
// rows of K samples (row stride K + 1) and the FIR output u[K][TM].
inline size_t smem_bytes(int K, int L, int TM) {
  return sizeof(float2) * ((size_t)K + (size_t)(TM + L - 1) * (K + 1) +
                           (size_t)K * TM);
}

__global__ void __launch_bounds__(kThreads)
channelize_kernel(const float2* __restrict__ xp, long long sS, int K, int L,
                  long long M, int TM, int lg_tm, long long tiles,
                  const float* __restrict__ hp,
                  const float2* __restrict__ wk, float2* __restrict__ y) {
  extern __shared__ float2 smem[];
  const int KP = K + 1;
  const int rows = TM + L - 1;
  float2* wsh = smem;             // [K] twiddles
  float2* xs = wsh + K;           // [rows][KP] staged input rows
  float2* ut = xs + rows * KP;    // [K][TM] FIR output, u[m, q] at q*TM + m
  const int tid = threadIdx.x;
  const long long s = blockIdx.x / tiles;
  const long long m0 = (blockIdx.x - s * tiles) * TM;
  const float2* xrow = xp + s * sS + m0 * K;
  // rows m0 + r of the stream exist for m0 + r < M + L - 1
  const long long avail = M + L - 1 - m0;
  const int valid = avail < rows ? (int)avail : rows;

  for (int i = tid; i < K; i += kThreads) wsh[i] = wk[i];
  for (int i = tid; i < rows * K; i += kThreads) {
    const int r = i / K;
    const int q = i - r * K;
    xs[r * KP + q] = r < valid ? xrow[i] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  // FIR: u[m, q] = sum_{d < L} hp[L-1-d, q] * x2[m + d, q]; lanes run over m
  for (int i = tid; i < K * TM; i += kThreads) {
    const int q = i >> lg_tm;
    const int m = i & (TM - 1);
    const float2* col = xs + m * KP + q;
    float h = __ldg(hp + (L - 1) * K + q);
    float2 v = col[0];
    float2 u = make_float2(h * v.x, h * v.y);
    for (int d = 1; d < L; ++d) {
      h = __ldg(hp + (L - 1 - d) * K + q);
      v = col[d * KP];
      u.x = fmaf(h, v.x, u.x);
      u.y = fmaf(h, v.y, u.y);
    }
    ut[i] = u;
  }
  __syncthreads();

  // IDFT: thread (kg, ml) owns samples ml + j*mlanes (j < kMB) of channel
  // groups kg, kg + nkg, ...; a group's kKB channels share each u load
  const int mlanes = TM / kMB;
  const int nkg = kThreads / mlanes;
  const int ml = tid % mlanes;
  const int kg = tid / mlanes;
  for (int kc = kg * kKB; kc < K; kc += nkg * kKB) {
    int kk[kKB], j[kKB];
    float2 acc[kKB][kMB];
#pragma unroll
    for (int c = 0; c < kKB; ++c) {
      kk[c] = min(kc + c, K - 1);  // a ragged last group repeats K - 1
      j[c] = kk[c] == 0 ? 0 : K - kk[c];  // ((K-1) * k) mod K at q = 0
#pragma unroll
      for (int b = 0; b < kMB; ++b) acc[c][b] = make_float2(0.f, 0.f);
    }
#pragma unroll 2
    for (int q = 0; q < K; ++q) {
      float2 u[kMB];
#pragma unroll
      for (int b = 0; b < kMB; ++b) u[b] = ut[q * TM + ml + b * mlanes];
#pragma unroll
      for (int c = 0; c < kKB; ++c) {
        const float2 w = wsh[j[c]];
#pragma unroll
        for (int b = 0; b < kMB; ++b) {
          acc[c][b].x = fmaf(u[b].x, w.x, acc[c][b].x);
          acc[c][b].x = fmaf(-u[b].y, w.y, acc[c][b].x);
          acc[c][b].y = fmaf(u[b].x, w.y, acc[c][b].y);
          acc[c][b].y = fmaf(u[b].y, w.x, acc[c][b].y);
        }
        j[c] -= kk[c];
        if (j[c] < 0) j[c] += K;
      }
    }
#pragma unroll
    for (int c = 0; c < kKB; ++c) {
      if (kc + c >= K) continue;
      float2* out = y + (s * K + kc + c) * M + m0;
#pragma unroll
      for (int b = 0; b < kMB; ++b) {
        const int m = ml + b * mlanes;
        if (m0 + m < M) out[m] = acc[c][b];
      }
    }
  }
}

}  // namespace lora

// Output samples per block for (K, L), 0 when no tile fits: at least 64,
// and enough that the block's threads all get channels (kThreads * kMB / TM
// groups of kKB); then halved while the tile takes more than half the
// shared memory (two blocks per SM) down to 32, and while it does not fit.
extern "C" int lora_channelize_tile(int K, int L) {
  using namespace lora;
  if (K < 1 || L < 1) return 0;
  const int groups = (K + kKB - 1) / kKB;
  int TM = 64;
  while (TM < kMB * kThreads && kThreads * kMB / TM > groups) TM *= 2;
  while (TM > 32 && smem_bytes(K, L, TM) > kMaxSmem / 2) TM /= 2;
  while (TM > kMB && smem_bytes(K, L, TM) > kMaxSmem) TM /= 2;
  return smem_bytes(K, L, TM) <= kMaxSmem ? TM : 0;
}

// xp: S streams of complex64 at row stride sS, each holding at least
// (M + L - 1) * K samples.  hp: float32 [L, K].  wk: complex64 [K].
// y: complex64 [S, K, M].
extern "C" int lora_channelize(const void* xp, long long sS, long long S,
                               int K, int L, long long M, const void* hp,
                               const void* wk, void* y, void* stream) {
  using namespace lora;
  if (S == 0 || M == 0) return 0;
  const int TM = lora_channelize_tile(K, L);
  if (TM == 0) return (int)cudaErrorInvalidValue;
  int lg_tm = 0;
  while ((1 << lg_tm) < TM) ++lg_tm;
  const size_t smem = smem_bytes(K, L, TM);
  const long long tiles = (M + TM - 1) / TM;
  const long long blocks = S * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      channelize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  channelize_kernel<<<(unsigned)blocks, kThreads, smem,
                      (cudaStream_t)stream>>>(
      static_cast<const float2*>(xp), sS, K, L, M, TM, lg_tm, tiles,
      static_cast<const float*>(hp), static_cast<const float2*>(wk),
      static_cast<float2*>(y));
  return (int)cudaGetLastError();
}
