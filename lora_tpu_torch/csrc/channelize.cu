// Kernel D: polyphase analysis filterbank, wideband -> K channels.
//
// Replaces both filterbank kernels of lora_tpu/ops/pallas_channelize.py:
// _filterbank_fir (pallas_call at :376, the factorized FIR + IDFT form with
// channel-major output) and _filterbank (pallas_call at :187, the dense
// block-Toeplitz product y = z0*W1 + z1*W2 with channel-minor output).  The
// two exist to fit the TPU's lanes and VMEM; here one entry computes the
// factorized form for any K and L whose tile fits shared memory:
//
//   u[m, q] = sum_l hp[l, q] * x2[m + L-1-l, q]          per-lane FIR
//   y[k, m] = sum_q u[m, q] * W[((K-1-q) * k) mod K]     K-point IDFT
//
// with x2[r, q] = xp[r*K + q] the (rows, K) view of the stream xp = history
// ++ block, hp the taps with the commutator's lane flip folded in
// (tables.fir_taps_flipped) and W the K-entry table e^{+2 pi i j/K}, rounded
// from float64 as tables.idft_k rounds it.  The output is channel-major
// complex64 [S, K, M], contiguous, so that reshape(S*K, M) is the demod bank
// with no copy.
//
// The stream is read through two pointers: sample i of stream s is
// hist[s, i] for i < L*K - 1 (a null `hist` reads as zeros: a filter that
// starts from rest) and x[s, i - (L*K - 1)] after, each with its own row
// stride.  Nobody concatenates history and block in device memory, and
// nobody allocates a zero history.  The block's part starts at an odd
// sample, so every load is 8 bytes.
//
// The second line is a forward K-point DFT in disguise:
//   W[((K-1-q) k) mod K] = e^{-2 pi i (q+1) k / K},
// so with u'[p] = u[m, (p - 1) mod K] (the phases rotated by one, which costs
// only an index) y[k, m] = sum_p u'[p] e^{-2 pi i p k / K}: no per-channel
// twist is left to multiply.
//
// What bounds it on the H100: a sample moves 16 bytes of device memory (8
// in, 8 out: 2.7 GB, 0.80 ms at 3.35 TB/s for the bank of 256 streams x 64
// channels x 10,240 samples) and costs 4L flop for the FIR and about
// 5 log2 K for a fast transform (62 at K = 64, L = 8: 0.16 ms at the float32
// rate), so device memory is the floor.  Next above it is the data path of
// shared memory and L1, 128 bytes a clock on each SM.  A FIR that reads L
// staged samples and L taps for each output sample (route 1 before the FIR
// by runs) takes about 2,300 of its wavefronts for a tile of 32 samples at
// K = 64, L = 8, about as many clocks as the tile's 32 KB take at an SM's
// share of 3.35 TB/s; route 1's FIR by runs reads 1.9 staged samples an
// output and its taps from registers.
//
// Three routes, chosen by K and the bf16 flag alone (lora_channelize_route):
//
// 1. float32, K a power of two from 8 to 1024: channelize_fft_kernel<log2 K,
//    LT>.  A block owns one stream's tile of TM output samples, with TM * R1
//    threads (BankPlan).
//    - Staging.  The tile's TM + L - 1 rows of K samples go to shared memory
//      once, by 8-byte cp.async, as [row][K] (zeros past the stream).
//    - FIR by runs.  An item is one position p of the rotated phases and
//      kRun = 8 consecutive samples.  It reads the column of phase
//      (p - 1) mod K in the kRun + L - 1 rows it needs once, lanes along p
//      so that a warp reads consecutive words, and slides its taps, held in
//      registers, over them: each output is the fmaf chain over d = 0 .. L -
//      1 from zero that filterbank_plain's reference emulates.  After a
//      barrier the sums go to u'[m][p] (row stride KP) over the staged rows.
//    - Transform.  Thread (m, c) reads the R0 values u'[m, c + (K/R0) j],
//      lanes along m (no bank conflict at the odd stride KP), transforms
//      them (fft.cuh: radix-2 in registers, every index a literal),
//      multiplies output m' by the pass twiddle W_K^(c m') from a table in
//      shared memory and writes position c + (K/R0) m' of the exchange
//      buffer [position][TM] over u'; after one barrier thread (m, f) reads
//      the R1 consecutive positions of run f, transforms them and stores
//      channel f + R0 m'' of its sample.  K = 8, 16, 32 take one pass (no
//      exchange); 64 = 8 x 8, 128 = 16 x 8, 256 = 16 x 16, 512 = 32 x 16,
//      1024 = 32 x 32 take two.  Every store of a channel row is TM
//      consecutive samples and every access of the exchange buffer a run of
//      consecutive 8-byte words.  At K = 1024 only TM = 8 fits; there a
//      half-warp holds two columns, u' has stride K + 2 and the exchange
//      buffer one padding row per run, which keeps both conflict-free.  Only
//      the FIR's reads at K = 8 meet a two-way conflict (a half-warp holds
//      two runs, 8 rows apart).
//    The arithmetic and its order are those of route 1 before the FIR by
//    runs, so y is bit-equal to it (max abs difference 0 at both wideband
//    cells' shapes, tools/torch_kernel_probe.py).
// 2. float32, every other K (24, 192, ...): channelize_kernel, the direct
//    sum over q, 8K flop a sample, bound by its float32 arithmetic (4.6 ms
//    for the bank above when it was the only route).  Each thread keeps a register tile
//    of kKB channels x kMB samples, so one u value loaded from shared memory
//    serves kKB complex multiply-adds and one twiddle serves kMB; the
//    twiddle index steps by -k per q with one conditional wrap.
//
// 3. bf16 (channelize(bf16=True)), every K: channelize_mma_kernel<NG, LT>.
//    The JAX package's factorized kernel with bf16=True (_filterbank_fir,
//    pallas_channelize.py:296-330) rounds the float32 FIR output u and its
//    IDFT matrix to bfloat16 and sums their products in float32: one real
//    product [Yr; Yi] = Wbig . [Ur; Ui] (_fir_idft_consts' W_big, [2K,
//    2K]) in the tensor cores' own type.  Here it is mma.sync m16n8k16
//    (bf16 in, float32 sums) by the rounded matrix of
//    cuda_channelize.idft_flipped(K), W'[q, k] = bf16(W[K-1-q, k]), bit for
//    bit the JAX package's.  A block owns one stream's tile of TM output
//    samples and every channel:
//    - K is padded to KW, a multiple of 16: zero rows and columns of the
//      real matrix and zero phases of u, which add exact zeros.
//    - FIR on the CUDA cores in route 2's arithmetic: u = h[L-1] x[m], then
//      fmaf(h[L-1-d], x[m+d], u) for d = 1 .. L-1, so u is bit-equal to
//      filterbank_fir_plain's.  A thread item is one phase q and kFirRun
//      consecutive samples; it loads the kFirRun + L - 1 stream rows it
//      needs straight into registers (all in flight at once, lanes along q:
//      256 contiguous bytes a warp load) and slides the taps over them, so
//      a row is read (kFirRun + L - 1) / kFirRun = 1.9 times from L1, not L
//      times from shared memory.  u goes to shared memory as bf16 pairs
//      (re, im), nearest even: ub[m][q], row stride KW + kUbPad words, the
//      product's contraction axis with re and im interleaved (column 2q re,
//      2q + 1 im).
//    - IDFT: D[2 KW, TM] = A . B, B = ub read by ldmatrix.x2 (a k-step's
//      two 8 x 8 halves for 8 samples; the 8 rows of a matrix fall into 8
//      bank quads since (KW + kUbPad) / 4 is odd), A = Wbig packed on the
//      host in fragment order (cuda_channelize.idft_packed): tile (t, ks),
//      lane l holds one uint4, one coalesced 16-byte load from L2 (L1 at
//      small K).  A warp item is two A tiles (16 channels) by NG n-tiles of
//      8 samples: 2 NG accumulators of 4 floats over the KW / 8 k-steps.
//    - Rows of Wbig: A tile t holds channels 8t .. 8t + 7, their real parts
//      in rows 0-7 and their imaginary parts in rows 8-15.  So lane (g, i)
//      = (l / 4, l % 4) holds {(Wr, -Wi), (Wi, Wr)} of (q, k) = (8 ks + i,
//      8t + g), then of q + 4, and its accumulators c0..c3 are Re y[k, n],
//      Re y[k, n+1], Im y[k, n], Im y[k, n+1] for n = 2i: one float4 store
//      (two float2 where M is odd), and a quad writes 64 contiguous bytes
//      of one channel row.
//    - TM: 256 at KW <= 32, 128 at KW <= 64, else 64, halved while ub takes
//      more than half of shared memory (two blocks an SM) down to 32, then
//      while it does not fit: K = 64 128 (34.8 KB), 256 64, 512 and 1024 32
//      (131.6 KB at 1024), 2048 16.  Every K up to 7,248 fits at TM = 8,
//      so every width route 2 took for bf16 (up to 5,810 at L = 1).
//    Wbig at K >= 128 (128 KB; 8 MB at K = 1024) does not fit in shared
//    memory beside the tile, so each block streams it from L2 in k-steps:
//    8 KW^2 bytes a tile, 8 K / TM bytes an output sample (4 at config 3;
//    256 at K = 1024, TM = 32: 8.6 GB of L2 reads for 2^25 samples).
//    Splitting the channels over blocks instead, each keeping a slice of
//    Wbig in shared memory (16 channels: 128 KB at K = 1024) and re-reading
//    the FIR's rows, reads 8 K / 16 = 512 bytes a sample of L2 for the rows
//    alone, twice as many: so the first.  Bound on the H100: 16 bytes of
//    device memory a sample, as routes 1 and 2, and 8K bf16 flop a sample
//    on the tensor cores (0.087 ms at config 3; at K = 1024 0.26 ms for
//    2^25 samples, above their 0.16 ms of bytes).  The tensor cores sum in
//    another order than a float32 loop, so y is not bit-equal to the plain
//    version's (within 3.3e-6 of the peak in chip_smoke.py step 8b).
//    Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/torch_kernel_probe.py
//    --sizes, route 3 in turns with the copy before it, whose bf16 flag took
//    route 2 at every K): the bank above 1.179 ms against 4.580 (route 1 in
//    float32 1.230 in the same call); 2^25 samples, L = 8, route 3 / the
//    old route 2 / float32: K = 8 0.462 / 0.455 / 0.217 ms, 16 0.345 /
//    0.535 / 0.237, 32 0.326 / 0.669 / 0.252, 64 0.348 / 0.997 / 0.297, 128
//    0.373 / 1.649 / 0.299, 256 0.446 / 3.290 / 0.283, 512 0.635 / 5.686 /
//    0.382, 1024 1.353 / 12.767 / 0.440, 24 0.386 / 0.619 / 0.632, 192
//    0.417 / 2.225 / 2.275.  Tried and not kept (in turns, one call each):
//    __launch_bounds__(256, 3), at most 85 registers, 1.326 against 1.155
//    ms at config 3 and 3.589 against 1.421 at K = 1024 (faster only at K <=
//    64 on 2^25 samples: K = 8 0.395 against 0.464); TM = 128 at KW > 64,
//    K = 128 0.382 and 0.409 against 0.357 and 0.382 at 64, K = 192 0.441
//    and 0.450 against 0.393 and 0.417; TM = 16 at K = 1024 (twice the L2
//    reads of Wbig, two blocks an SM) 1.384 against 1.421, so those reads
//    are not what holds K = 1024 there (not separated: no ncu); the next
//    k-step's A loaded a step ahead, 1.349 against 1.349 at K = 1024 and
//    1.179 against 1.190 at config 3.
//
// The dense form of the JAX package (about 8*(L+G-1)*K flop per sample) is
// the plain version's matrix product, not this kernel's.  The float32
// routes use no wgmma or TMA: a float32 product on the tensor cores would
// round its operands to TF32.
//
// Measured, the float32 routes (NVIDIA H100 80GB HBM3, 700.00 W; 256
// streams x 64 channels x 10,240 samples, L = 8, no history; every row one
// call, in turns): the
// direct sum alone 4.60 ms, 5.73 with the concatenation it needed; route 1
// with the rows staged through registers one load at a time 1.50 ms; eight
// loads in flight a thread 1.27; cp.async 1.19; the FIR loop unrolled in full
// for L = 8 (LT) 1.10 to 1.16.  Other widths (2^25 samples, L = 8, route 1
// against the direct sum): K = 8 0.22 against 0.46 ms, 128 0.27 / 1.55, 1024
// 0.46 / 12.75.  Route 2 with two pointers and cp.async stays within 7% of
// the one-pointer kernel it was (K = 24 0.60 against 0.63 ms, K = 192 2.22
// against 2.08), without the pass over the bank that kernel needed first.
// A warp a staged row on route 2 (no index divided by K): K = 192 2.17 ms,
// K = 24 0.66 (24 of 32 lanes busy): not kept.
// Tried and not kept: TM = 64 at K = 64 (512 threads, a ninth of the rows
// re-read by the next tile instead of a fifth), 1.28 against 1.21 ms.
//
// Route 1 with the FIR by runs (tools/torch_kernel_probe.py on the H100
// above, no history, in turns against the kernel before it, one call; the
// bound by bytes at 3.35 TB/s): K = 64, L = 8, 256 x 786,432 samples 1.103
// against 1.386 ms (87.2% against 69.4% of 0.962 ms), 128 x 4,194,304 2.952
// against 3.669 (86.9% against 69.9% of 2.564 ms); 2^25 samples, L = 8, the
// kernel before / this: K = 8 0.248 / 0.236 ms, 16 0.240 / 0.217, 32 0.275
// / 0.241, 64 0.284 / 0.251, 128 0.281 / 0.250, 256 0.285 / 0.232, 512
// 0.374 / 0.273, 1024 0.425 / 0.349.  Tried and not kept (each in turns
// with the rest of its call; shares at the two cells' shapes):
// - A walk: a block takes a run of tiles of one stream, keeps each tile's
//   last L - 1 rows in a ring for the next, copies the next tile's rows
//   while it filters the current one (a ring of 2 TM + L - 1 rows) or
//   while it transforms it, builds the twiddles once; runs cut from S, M
//   and the SM count so that the waves waste least: 79.4% / 81.8% against
//   86.2% / 85.7% for the same kernel at runs of one tile.  Fixed runs: one
//   tile 85.0 / 86.9%, two 84.9 / 86.4%, four 82.0 / 84.5%, eight 81.9 /
//   85.8%, sixteen 81.0 / 85.3%; one wave of equal runs 80.3 / 80.6%; at
//   2^25 samples runs of one tile were the fastest at every width, and the
//   rule's long runs slower than the kernel before at K = 8 and 1024.
//   Long runs put the blocks that run at once far apart in the stream,
//   each writing its own 256-byte pieces of 64 channel rows, and fix the
//   work of each block; tiles side by side write the same rows side by
//   side and the hardware balances them (not separated: no ncu).
// - In the walk: without the tile ahead 78.5 / 82.0%, streaming stores
//   (__stcs) 78.3 / 82.1%, 8-byte copies 80.1 / 81.9%, against 79.4 /
//   81.8%.
// - The rows staged from one sample earlier, so that x comes in 16-byte
//   copies, with u' beside them where both fit: 87.6 / 87.7% against 87.0
//   / 86.2% in one call, 85.8 / 87.3% against 85.2 / 86.4% in another,
//   within the 1 to 5 points that the rounds of one call part by; at 2^25
//   samples within 0.016 ms of this kernel either way at every width but
//   K = 256 (0.272 ms at TM = 16).  Not worth the shifted indexing and the
//   second layout.
// - u' beside the rows where both fit, 8-byte copies (or u' over the rows
//   with the shared memory of both, which leaves fewer blocks an SM): 83.3
//   / 82.1% and 83.3 / 82.3%, against 87.0 / 86.2%; faster at K = 128
//   (0.227 and 0.229 against 0.252 ms), not at the cells' width.
// - K = 256 at TM = 16, the tile of the kernel before (128-byte pieces of
//   each channel row): 0.311 ms against 0.232 at TM = 32.  TM = 32 leaves
//   filters of L = 82 to 97 at K = 256 to route 2.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "fft.cuh"

namespace lora {

constexpr size_t kMaxSmem = 232448;  // bytes of shared memory per block, sm_90

// One stream: `hist` (n_hist samples, or null for zeros) followed by `x`.
struct Stream {
  const float2* hist;
  const float2* x;
  long long n_hist;
};

// Start the copy of sample i of the stream to `dst` in shared memory, past
// the registers (cp.async, 8 bytes); zeros are stored at once.
__device__ __forceinline__ void stage_async(float2* dst, const Stream& st,
                                            long long i) {
  if (i >= st.n_hist)
    __pipeline_memcpy_async(dst, st.x + (i - st.n_hist), sizeof(float2));
  else if (st.hist != nullptr)
    __pipeline_memcpy_async(dst, st.hist + i, sizeof(float2));
  else
    *dst = make_float2(0.f, 0.f);
}

// ---------------------------------------------------------------------------
// route 1: K a power of two, the FIR by runs, a register FFT
// ---------------------------------------------------------------------------

// The passes of each width K = 2^LK: radices R0 (first pass) and R1 (second
// pass; 1: a single pass), and the tile TM of output samples a block owns.
// A block has TM * R1 threads.
template <int LK> struct BankPlan;
template <> struct BankPlan<3>  { enum { R0 = 8,  R1 = 1,  TM = 256 }; };
template <> struct BankPlan<4>  { enum { R0 = 16, R1 = 1,  TM = 256 }; };
template <> struct BankPlan<5>  { enum { R0 = 32, R1 = 1,  TM = 128 }; };
template <> struct BankPlan<6>  { enum { R0 = 8,  R1 = 8,  TM = 32 }; };
template <> struct BankPlan<7>  { enum { R0 = 16, R1 = 8,  TM = 32 }; };
template <> struct BankPlan<8>  { enum { R0 = 16, R1 = 16, TM = 32 }; };
template <> struct BankPlan<9>  { enum { R0 = 32, R1 = 16, TM = 16 }; };
template <> struct BankPlan<10> { enum { R0 = 32, R1 = 32, TM = 8 }; };

// Consecutive output samples of one position that a FIR item of route 1
// forms from one column of the staged rows.
constexpr int kRun = 8;

template <int LK> struct BankGeo {
  using Pl = BankPlan<LK>;
  static constexpr int K = 1 << LK;
  static constexpr int R0 = Pl::R0, R1 = Pl::R1, TM = Pl::TM;
  static constexpr bool kTwoPass = R1 > 1;
  static constexpr int kThreads = TM * R1;
  // FIR items a thread: K * TM / kRun items over kThreads threads
  static constexpr int kItems = R0 / kRun;
  // row stride of the FIR output u'[m][p]: lanes on consecutive samples, and
  // the two columns of a half-warp at TM = 8, fall into different 8-byte banks
  static constexpr int KP = K + (TM >= 16 ? 1 : 2);
  static constexpr int kPadShift = ilog2(R1);
  // float2 elements of the exchange buffer [position][TM]; at TM < 16 one
  // padding position per run of R1
  static constexpr int kEx = kTwoPass ? (K + (TM < 16 ? K / R1 : 0)) * TM : 0;
  // the FIR output, over which the exchange buffer lies
  static constexpr int kUb = TM * KP > kEx ? TM * KP : kEx;
  static constexpr int kTw = kTwoPass ? K : 0;  // W_K^(c m') as [m'][c]
  static_assert(R0 * R1 == K, "plan");
  static_assert(!kTwoPass || R0 % R1 == 0, "plan");
  static_assert((TM & (TM - 1)) == 0 && kThreads <= 1024, "plan");
  static_assert(TM % kRun == 0 && R0 % kRun == 0, "plan");

  __host__ __device__ static constexpr int pad(int p) {
    return TM < 16 ? p + (p >> kPadShift) : p;
  }
  // shared memory of a block: the pass twiddles, then the staged rows
  // [TM + L - 1][K], over which u' and then the exchange buffer lie
  static size_t smem_bytes(int L) {
    const size_t rows = (size_t)(TM + L - 1) * K;
    return sizeof(float2) * (kTw + (rows > (size_t)kUb ? rows : (size_t)kUb));
  }
};

// The filter length whose FIR loop is unrolled in full (LT = kTapsUnrolled:
// the default of ops/channelizer.channelize); any other L runs the same loop
// with a runtime bound (LT = 0).
constexpr int kTapsUnrolled = 8;

template <int LK, int LT>
__global__ void __launch_bounds__(BankGeo<LK>::kThreads)
channelize_fft_kernel(const float2* __restrict__ hist, long long sH,
                      const float2* __restrict__ x, long long sX, int taps,
                      long long M, long long tiles,
                      const float* __restrict__ hp,
                      const float2* __restrict__ wk, float2* __restrict__ y) {
  using G = BankGeo<LK>;
  constexpr int K = G::K, R0 = G::R0, R1 = G::R1, TM = G::TM, KP = G::KP;
  constexpr int NT = G::kThreads;
  extern __shared__ float2 smem[];
  float2* tw = smem;           // [K] pass twiddles (two passes only)
  float2* xs = smem + G::kTw;  // [TM + L - 1][K] staged input rows
  float2* ub = xs;             // [TM][KP] FIR output u'[m][p], after the FIR
  float2* ex = xs;             // [K (+ padding)][TM] exchange, after the pass
  const int L = LT > 0 ? LT : taps;  // a literal where the loop is unrolled
  const int tid = threadIdx.x;
  const long long s = blockIdx.x / tiles;
  const long long m0 = (blockIdx.x - s * tiles) * TM;
  const int rows = TM + L - 1;
  // rows m0 + r of the stream exist for m0 + r < M + L - 1
  const long long avail = M + L - 1 - m0;
  const int valid = avail < rows ? (int)avail : rows;
  const Stream st{hist != nullptr ? hist + s * sH : nullptr, x + s * sX,
                  (long long)L * K - 1};

  if constexpr (G::kTwoPass) {
    // tw[m' * R1 + c] = W_K^(c m') = conj(wk[(c m') mod K])
    for (int i = tid; i < K; i += G::kThreads) {
      const float2 w = __ldg(wk + (((i / R1) * (i % R1)) & (K - 1)));
      tw[i] = make_float2(w.x, -w.y);
    }
  }
  const long long g0 = m0 * K;  // the tile's first sample of the stream
  for (int i = tid; i < rows * K; i += NT) {
    if ((i >> LK) < valid)
      stage_async(xs + i, st, g0 + i);
    else
      xs[i] = make_float2(0.f, 0.f);
  }
  // this thread's FIR items: position p = j mod K of run j / K (kRun
  // consecutive samples), j = tid + it * NT; with LT > 0 their taps
  // h[d] = hp[L-1-d, (p - 1) mod K] go to registers while the rows land
  float h[G::kItems][LT > 0 ? LT : 1];
  if constexpr (LT > 0) {
#pragma unroll
    for (int it = 0; it < G::kItems; ++it) {
      const int q = (((tid + it * NT) & (K - 1)) - 1) & (K - 1);
#pragma unroll
      for (int d = 0; d < LT; ++d) h[it][d] = __ldg(hp + (LT - 1 - d) * K + q);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // FIR: u'[m, p] = u[m, q] = sum_{d < L} hp[L-1-d, q] * x2[m + d, q] with
  // q = (p - 1) mod K: item (p, run) reads column q of staged rows m + d
  // once each, lanes along p, and slides the taps over them
  float2 acc[G::kItems][kRun];
#pragma unroll
  for (int it = 0; it < G::kItems; ++it) {
    const int j = tid + it * NT;
    const int q = ((j & (K - 1)) - 1) & (K - 1);
    const float2* col = xs + (j >> LK) * kRun * K + q;
#pragma unroll
    for (int r = 0; r < kRun; ++r) acc[it][r] = make_float2(0.f, 0.f);
    if constexpr (LT > 0) {
      // row r of the column feeds sample i at tap d = r - i
#pragma unroll
      for (int r = 0; r < kRun + LT - 1; ++r) {
        const float2 a = col[r * K];
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          if (r - i >= 0 && r - i < LT) {
            acc[it][i].x = fmaf(h[it][r - i], a.x, acc[it][i].x);
            acc[it][i].y = fmaf(h[it][r - i], a.y, acc[it][i].y);
          }
        }
      }
    } else {
      for (int d = 0; d < L; ++d) {
        const float hd = __ldg(hp + (L - 1 - d) * K + q);
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const float2 a = col[(i + d) * K];
          acc[it][i].x = fmaf(hd, a.x, acc[it][i].x);
          acc[it][i].y = fmaf(hd, a.y, acc[it][i].y);
        }
      }
    }
  }
  __syncthreads();  // every row is read: u' goes over them
#pragma unroll
  for (int it = 0; it < G::kItems; ++it) {
    const int j = tid + it * NT;
    float2* out = ub + (j >> LK) * kRun * KP + (j & (K - 1));
#pragma unroll
    for (int i = 0; i < kRun; ++i) out[i * KP] = acc[it][i];
  }
  __syncthreads();

  // first pass: thread (m, c) takes u'[m, c + R1 j], j < R0, lanes along m
  const int m = tid & (TM - 1);
  const int c = tid / TM;
  float2 v[R0];
  const float2* um = ub + m * KP + c;
#pragma unroll
  for (int j = 0; j < R0; ++j) v[j] = um[R1 * j];
  fft_reg<R0>(v);

  const bool live = m0 + m < M;
  if constexpr (!G::kTwoPass) {
    // register p holds channel brev(p)
    if (live) {
      float2* out = y + s * K * M + m0 + m;
#pragma unroll
      for (int k = 0; k < R0; ++k) out[k * M] = v[brev<ilog2(R0)>(k)];
    }
  } else {
    __syncthreads();  // every thread has read u': it becomes `ex`
#pragma unroll
    for (int mp = 0; mp < R0; ++mp) {
      float2 a = v[brev<ilog2(R0)>(mp)];
      if (mp) a = cmul(a, tw[mp * R1 + c]);
      ex[G::pad(c + R1 * mp) * TM + m] = a;
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < R0 / R1; ++b) {
      const int f = c + R1 * b;  // run f: positions f*R1 .. f*R1 + R1 - 1
      float2 w[R1];
#pragma unroll
      for (int j = 0; j < R1; ++j) w[j] = ex[G::pad(f * R1 + j) * TM + m];
      fft_reg<R1>(w);
      if (live) {
        // register p holds channel f + R0 * brev(p)
        float2* out = y + (s * K + f) * M + m0 + m;
#pragma unroll
        for (int mq = 0; mq < R1; ++mq)
          out[(long long)R0 * mq * M] = w[brev<ilog2(R1)>(mq)];
      }
    }
  }
}

template <int LK>
size_t fft_smem(int L) {
  return BankGeo<LK>::smem_bytes(L);
}

template <int LK>
int launch_fft(const float2* hist, long long sH, const float2* x, long long sX,
               long long S, int L, long long M, const float* hp,
               const float2* wk, float2* y, cudaStream_t stream) {
  using G = BankGeo<LK>;
  const size_t smem = G::smem_bytes(L);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long tiles = (M + G::TM - 1) / G::TM;
  const long long blocks = S * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = L == kTapsUnrolled ? channelize_fft_kernel<LK, kTapsUnrolled>
                                   : channelize_fft_kernel<LK, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, G::kThreads, smem, stream>>>(hist, sH, x, sX, L, M,
                                                          tiles, hp, wk, y);
  return (int)cudaGetLastError();
}

// `return fn<log2 K>(args...);` for K a power of two in 8..1024, else
// `otherwise`.
#define LORA_FOR_BANK_WIDTH(K, otherwise, fn, ...) \
  switch (K) {                                     \
    case 8: return fn<3>(__VA_ARGS__);             \
    case 16: return fn<4>(__VA_ARGS__);            \
    case 32: return fn<5>(__VA_ARGS__);            \
    case 64: return fn<6>(__VA_ARGS__);            \
    case 128: return fn<7>(__VA_ARGS__);           \
    case 256: return fn<8>(__VA_ARGS__);           \
    case 512: return fn<9>(__VA_ARGS__);           \
    case 1024: return fn<10>(__VA_ARGS__);         \
    default: return otherwise;                     \
  }

// Shared memory of route 1 for (K, L); more than any block has where K is
// not one of its widths.
size_t fft_smem_of(int K, int L) {
  LORA_FOR_BANK_WIDTH(K, kMaxSmem + 1, fft_smem, L)
}

// ---------------------------------------------------------------------------
// route 2: any K, the direct sum
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kMB = 2;  // output samples per thread
constexpr int kKB = 8;  // channels per thread

// Shared memory of one tile: the K-entry twiddle table, TM + L - 1 staged
// rows of K samples (row stride K + 1) and the FIR output u[K][TM].
inline size_t smem_bytes(int K, int L, int TM) {
  return sizeof(float2) * ((size_t)K + (size_t)(TM + L - 1) * (K + 1) +
                           (size_t)K * TM);
}

// Output samples per block for (K, L), 0 when no tile fits: at least 64,
// and enough that the block's threads all get channels (kThreads * kMB / TM
// groups of kKB); then halved while the tile takes more than half the
// shared memory (two blocks per SM) down to 32, and while it does not fit.
int direct_tile(int K, int L) {
  const int groups = (K + kKB - 1) / kKB;
  int TM = 64;
  while (TM < kMB * kThreads && kThreads * kMB / TM > groups) TM *= 2;
  while (TM > 32 && smem_bytes(K, L, TM) > kMaxSmem / 2) TM /= 2;
  while (TM > kMB && smem_bytes(K, L, TM) > kMaxSmem) TM /= 2;
  return smem_bytes(K, L, TM) <= kMaxSmem ? TM : 0;
}

__global__ void __launch_bounds__(kThreads)
channelize_kernel(const float2* __restrict__ hist, long long sH,
                  const float2* __restrict__ x, long long sX, int K, int L,
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
  // rows m0 + r of the stream exist for m0 + r < M + L - 1
  const long long avail = M + L - 1 - m0;
  const int valid = avail < rows ? (int)avail : rows;
  const Stream st{hist != nullptr ? hist + s * sH : nullptr, x + s * sX,
                  (long long)L * K - 1};

  for (int i = tid; i < K; i += kThreads) wsh[i] = wk[i];
  const long long g0 = m0 * K;  // the tile's first sample of the stream
  for (int i = tid; i < rows * K; i += kThreads) {
    const int r = i / K;
    const int q = i - r * K;
    if (r < valid)
      stage_async(xs + r * KP + q, st, g0 + i);
    else
      xs[r * KP + q] = make_float2(0.f, 0.f);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
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

int launch_direct(const float2* hist, long long sH, const float2* x,
                  long long sX, long long S, int K, int L, long long M,
                  const float* hp, const float2* wk, float2* y,
                  cudaStream_t stream) {
  const int TM = direct_tile(K, L);
  if (TM == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K, L, TM);
  const long long tiles = (M + TM - 1) / TM;
  const long long blocks = S * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      channelize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  channelize_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      hist, sH, x, sX, K, L, M, TM, ilog2(TM), tiles, hp, wk, y);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// route 3: bf16, the FIR on the CUDA cores and the IDFT on the tensor cores
// (the design and its numbers: item 3 at the top of this file)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;
constexpr int kFirRun = 8;  // consecutive samples of one phase a FIR item
constexpr int kUbPad = 4;   // words after each row of ub

// K padded to whole A tiles of 8 channels, in pairs
__host__ __device__ constexpr int mma_width(int K) { return (K + 15) & ~15; }

inline size_t mma_smem(int K, int TM) {
  return sizeof(unsigned) * (size_t)TM * (mma_width(K) + kUbPad);
}

// Output samples per block for K, 0 where no tile fits.
int mma_tile(int K) {
  int TM = mma_width(K) <= 32 ? 256 : mma_width(K) <= 64 ? 128 : 64;
  while (TM > 32 && mma_smem(K, TM) > kMaxSmem / 2) TM /= 2;
  while (TM > 8 && mma_smem(K, TM) > kMaxSmem) TM /= 2;
  return mma_smem(K, TM) <= kMaxSmem ? TM : 0;
}

// Sample i of the stream, read once through L1.
__device__ __forceinline__ float2 sample(const Stream& st, long long i) {
  if (i >= st.n_hist) return __ldg(st.x + (i - st.n_hist));
  if (st.hist != nullptr) return __ldg(st.hist + i);
  return make_float2(0.f, 0.f);
}

// (re, im) rounded to bfloat16, nearest even, re in the low half.
__device__ __forceinline__ unsigned pack_bf16(float2 u) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(u.x, u.y);
  return *reinterpret_cast<const unsigned*>(&b);
}

__device__ __forceinline__ void ldmatrix_x2(unsigned& r0, unsigned& r1,
                                            unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d += A . B for one 16 x 16 A fragment and one 16 x 8 B fragment
__device__ __forceinline__ void mma_bf16(float* d, const uint4& a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

template <int NG, int LT>
__global__ void __launch_bounds__(kMmaThreads, 2)
channelize_mma_kernel(const float2* __restrict__ hist, long long sH,
                      const float2* __restrict__ x, long long sX, int K,
                      int taps, long long M, int TM, long long tiles,
                      const float* __restrict__ hp,
                      const uint4* __restrict__ wb, float2* __restrict__ y) {
  extern __shared__ unsigned ub[];  // [TM][KW + kUbPad] bf16 (re, im)
  const int KW = mma_width(K);
  const int SW = KW + kUbPad;
  const int L = LT > 0 ? LT : taps;  // a literal where the loop is unrolled
  const int tid = threadIdx.x;
  const long long s = blockIdx.x / tiles;
  const long long m0 = (blockIdx.x - s * tiles) * TM;
  // rows m0 + r of the stream exist for r < avail
  const long long avail = M + L - 1 - m0;
  const Stream st{hist != nullptr ? hist + s * sH : nullptr, x + s * sX,
                  (long long)L * K - 1};
  const float2 zero = make_float2(0.f, 0.f);

  // FIR: item (run, q) gives u[m0 + r, q] for r in run * kFirRun + [0, kFirRun)
  for (int i = tid; i < (TM / kFirRun) * KW; i += kMmaThreads) {
    const int run = i / KW;
    const int q = i - run * KW;
    const int r0 = run * kFirRun;
    unsigned* out = ub + r0 * SW + q;
    if (q >= K) {  // a padding phase
#pragma unroll
      for (int r = 0; r < kFirRun; ++r) out[r * SW] = 0u;
      continue;
    }
    const long long g = (m0 + r0) * K + q;  // row m0 + r0, phase q
    float2 u[kFirRun];
    if constexpr (LT > 0) {
      float h[LT];
#pragma unroll
      for (int d = 0; d < LT; ++d) h[d] = __ldg(hp + (LT - 1 - d) * K + q);
      float2 xr[kFirRun + LT - 1];
#pragma unroll
      for (int j = 0; j < kFirRun + LT - 1; ++j)
        xr[j] = r0 + j < avail ? sample(st, g + (long long)j * K) : zero;
#pragma unroll
      for (int r = 0; r < kFirRun; ++r) {
        u[r] = make_float2(h[0] * xr[r].x, h[0] * xr[r].y);
#pragma unroll
        for (int d = 1; d < LT; ++d) {
          u[r].x = fmaf(h[d], xr[r + d].x, u[r].x);
          u[r].y = fmaf(h[d], xr[r + d].y, u[r].y);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kFirRun; ++r) u[r] = zero;
      for (int d = 0; d < L; ++d) {
        const float h = __ldg(hp + (L - 1 - d) * K + q);
#pragma unroll
        for (int r = 0; r < kFirRun; ++r) {
          const float2 v = r0 + r + d < avail
                               ? sample(st, g + (long long)(r + d) * K)
                               : zero;
          if (d == 0) {
            u[r] = make_float2(h * v.x, h * v.y);
          } else {
            u[r].x = fmaf(h, v.x, u[r].x);
            u[r].y = fmaf(h, v.y, u[r].y);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kFirRun; ++r) out[r * SW] = pack_bf16(u[r]);
  }
  __syncthreads();

  // IDFT: warp item (pair p, group) = A tiles 2p, 2p + 1 by NG n-tiles
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, iq = lane & 3;
  const int KS = KW / 8;  // k-steps of 16 (8 phases, re and im)
  const int pairs = KW / 16;
  const int groups = TM / (8 * NG);
  const bool even = (M & 1) == 0;
  // ldmatrix row of this lane (lanes 0-15): sample lane % 8, half lane / 8
  const unsigned b_lane = (unsigned)__cvta_generic_to_shared(
      ub + (lane & 7) * SW + ((lane >> 3) & 1) * 4);
  for (int item = warp; item < pairs * groups; item += kMmaThreads / 32) {
    const int p = item / groups;
    const int n0 = (item - p * groups) * 8 * NG;
    float acc[2][NG][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int nt = 0; nt < NG; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[t][nt][c] = 0.f;
    const uint4* a_lo = wb + (size_t)(2 * p) * KS * 32 + lane;
    const uint4* a_hi = a_lo + (size_t)KS * 32;
    const unsigned b_at = b_lane + n0 * SW * 4;
    for (int ks = 0; ks < KS; ++ks) {
      const uint4 a0 = __ldg(a_lo + ks * 32);
      const uint4 a1 = __ldg(a_hi + ks * 32);
#pragma unroll
      for (int nt = 0; nt < NG; ++nt) {
        unsigned b0, b1;
        ldmatrix_x2(b0, b1, b_at + (nt * 8 * SW + ks * 8) * 4);
        mma_bf16(acc[0][nt], a0, b0, b1);
        mma_bf16(acc[1][nt], a1, b0, b1);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int k = (2 * p + t) * 8 + gq;
      if (k >= K) continue;
      float2* out = y + (s * K + k) * M + m0;
#pragma unroll
      for (int nt = 0; nt < NG; ++nt) {
        const int m = n0 + nt * 8 + 2 * iq;
        const float* c = acc[t][nt];
        if (even && m0 + m + 1 < M) {
          *reinterpret_cast<float4*>(out + m) =
              make_float4(c[0], c[2], c[1], c[3]);
        } else {
          if (m0 + m < M) out[m] = make_float2(c[0], c[2]);
          if (m0 + m + 1 < M) out[m + 1] = make_float2(c[1], c[3]);
        }
      }
    }
  }
}

// Route 3's kernel for NG n-tiles a warp item and filter length L.
template <int NG>
auto mma_kernel(int L) {
  return L == kTapsUnrolled ? channelize_mma_kernel<NG, kTapsUnrolled>
                            : channelize_mma_kernel<NG, 0>;
}

int launch_mma(const float2* hist, long long sH, const float2* x,
               long long sX, long long S, int K, int L, long long M,
               const float* hp, const uint4* wb, float2* y,
               cudaStream_t stream) {
  const int TM = mma_tile(K);
  if (TM == 0 || L < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = mma_smem(K, TM);
  const long long tiles = (M + TM - 1) / TM;
  const long long blocks = S * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // NG: 4 wherever TM allows
  auto kernel = TM >= 32 ? mma_kernel<4>(L)
                : TM == 16 ? mma_kernel<2>(L) : mma_kernel<1>(L);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kMmaThreads, smem, stream>>>(
      hist, sH, x, sX, K, L, M, TM, tiles, hp, wb, y);
  return (int)cudaGetLastError();
}

}  // namespace lora

// The route of (K, L): in float32 1 the register FFT (K a power of two from
// 8 to 1024 whose staged rows fit shared memory), 2 the direct sum (any
// other K, or a filter too long for route 1, whose tile fits); with bf16 3,
// the tensor cores' product (any K up to 7,248, any L); 0 none.
extern "C" int lora_channelize_route(int K, int L, int bf16) {
  using namespace lora;
  if (K < 1 || L < 1) return 0;
  if (bf16) return mma_tile(K) > 0 ? 3 : 0;
  if (fft_smem_of(K, L) <= kMaxSmem) return 1;
  return direct_tile(K, L) > 0 ? 2 : 0;
}

// Sample i of stream s < S is hist[s*sH + i] for i < L*K - 1 and
// x[s*sX + i - (L*K - 1)] after (complex64; a null hist reads as zeros); x
// holds M*K samples a stream.  hp: float32 [L, K].  wk: complex64 [K].
// y: complex64 [S, K, M].  bf16 must be 0: the bf16 route takes its matrix
// through lora_channelize_bf16.  The flag stays last, so that an older
// caller binds as before.
extern "C" int lora_channelize(const void* hist, long long sH, const void* x,
                               long long sX, long long S, int K, int L,
                               long long M, const void* hp, const void* wk,
                               void* y, void* stream, int bf16) {
  using namespace lora;
  if (bf16) return (int)cudaErrorInvalidValue;
  if (S == 0 || M == 0) return 0;
  const float2* h = static_cast<const float2*>(hist);
  const float2* xx = static_cast<const float2*>(x);
  const float* taps = static_cast<const float*>(hp);
  const float2* w = static_cast<const float2*>(wk);
  float2* out = static_cast<float2*>(y);
  cudaStream_t st = (cudaStream_t)stream;
  if (lora_channelize_route(K, L, 0) != 1)
    return launch_direct(h, sH, xx, sX, S, K, L, M, taps, w, out, st);
  LORA_FOR_BANK_WIDTH(K, (int)cudaErrorInvalidValue, launch_fft, h, sH, xx, sX,
                      S, L, M, taps, w, out, st)
}

// The bf16 route (3): as lora_channelize, with the FIR output rounded to
// bfloat16 and the IDFT by wbig, the rounded matrix packed in fragment order:
// bfloat16 [KW/8][KW/8][32][8], KW = K rounded up to 16
// (ops/cuda_channelize.idft_packed).
extern "C" int lora_channelize_bf16(const void* hist, long long sH,
                                    const void* x, long long sX, long long S,
                                    int K, int L, long long M, const void* hp,
                                    const void* wbig, void* y, void* stream) {
  using namespace lora;
  if (S == 0 || M == 0) return 0;
  return launch_mma(static_cast<const float2*>(hist), sH,
                    static_cast<const float2*>(x), sX, S, K, L, M,
                    static_cast<const float*>(hp),
                    static_cast<const uint4*>(wbig), static_cast<float2*>(y),
                    (cudaStream_t)stream);
}
