// Kernel G: a bank of LoRa frames decoded in one launch, symbols to bytes.
//
// Stands for XLA's fusion of lora_tpu/models/decoder.py's jitted `decode`
// (there is no pallas_call): the Gray map, the diagonal deinterleave, the
// dewhitening, the Hamming/parity FEC decode, the header parse and
// checksum, the reference's error-mask loop bounds, the byte assembly, the
// CRC16 with its masking register, the unmasking and the status chain, bit
// for bit as the plain route (models/decoder.decode_plain) computes them.
// Op by op that route is about 550 small launches a call whatever the bank
// (masked_crc16 alone loops over every byte position with eight elementwise
// kernels a byte), which is what bounded it on the H100: about 1 ms a call.
//
// What bounds it on the H100: one launch.  The bytes are few (SF10 CR 4/8,
// 4096 frames: 0.56 MB of int16 symbols in, 0.3 MB of bytes and fields out,
// 0.3 us at 3.35 TB/s); what is left is a few short serial chains a frame.
// The design follows from that:
//   - a block takes `frames` consecutive frames (64, halved until its tiles
//     fit in shared memory: one frame of the longest row the wrapper takes,
//     2,048 payload codewords, needs about 6 KB), so 4096 frames fill 64
//     blocks;
//   - phase A: the whole block stages its rows' symbols, Gray-mapped, and
//     the lookup tables (the FEC decode of every rate, the whitening values
//     of this frame length, the CRC16 step table, the CRC masking register)
//     in shared memory; the rows of a block are one contiguous run of the
//     symbols, so these reads coalesce, and they are unrolled so that many
//     are in flight at once;
//   - phase B: the whole block forms every (frame, codeword) pair's
//     codeword from the staged symbols (deinterleave and dewhiten), each
//     pair independent of the others;
//   - phase C: one thread a frame walks the serial part: the header, the
//     FEC decode at the header-announced rate, the error mask, the bytes,
//     the CRC register over at most max_bytes steps, the status chain;
//   - phase D: the whole block writes its frames' bytes, one contiguous
//     run of the output, coalesced.
// Each tile's row stride is an odd number of 4-byte words, so the threads
// of phase C, one a row, read distinct shared-memory banks.
//
// The reference's quirks stay: the header checksum is never verified; a
// corrupt header may announce rdd 5 to 7 (nibble 0, no error, not bad, then
// DROP_HEADER_RDD); the codeword tail past the symbols decodes as the raw
// whitening stream; explicit mode without CRC gives length - 5; the header
// block is over-counted at rates other than 4/8.  Symbols are read in the
// dtype they arrive in (template T) and Gray-mapped in 64 bits, as the
// plain route's int64 arithmetic does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace lora {

constexpr int kDecThreads = 256;
constexpr int kMaxFrames = 64;
constexpr int kMaxSmem = 232448;  // 227 KB, what a block may opt in to
constexpr int kHeaderRdd = 4;
constexpr int kHeaderCodewords = 5;
constexpr int kHeaderSymbols = 8;
constexpr int kRate = 256;  // entries of one rate's row in the FEC table

// status codes (models/decoder.py)
constexpr int kOk = 0, kDropHeaderFec = 1, kDropHeaderRdd = 2,
              kDropLength = 3, kDropFec = 4, kDropCrc = 5;

// The static geometry of a call: ncw, nexist and K as ops/cuda_decode.py's
// geometry() forms them, the rest from those and the configuration.
struct DecodeGeo {
  long long B, rs, cs;  // rows, row and column strides of the symbols
  int S;                // symbols a row
  int K;                // symbols a row staged: the rest read as 0
  int shift;            // sf - ppm
  long long half;       // (1 << shift) / 2
  int ppm, nbits, rdd;
  int explicit_header, hdr, crc_check, error_check, interleaving;
  int data_length;
  int ncw;              // codewords a frame
  int start;            // header codewords (5 explicit, else 0)
  int n_pay, n0, n1, straggler, d_ofs0;
  int hb;               // header bytes ahead of the payload's (3 or 0)
  int M;                // bytes a frame (max_bytes)
  int nexist;           // codeword blocks deinterleaved; later ones are 0
  int frames;           // frames a block
  int sst, cst, bst;    // row strides: symbols (uint16), codewords, bytes
  int off_cw, off_bytes, off_crc, off_dec, off_wz, off_mask;
};

__host__ __device__ __forceinline__ int floor_mod(long long a, long long m) {
  const long long r = a % m;
  return (int)(r < 0 ? r + m : r);
}

// The 5-bit header checksum (LoRaCodes.hpp:31-55).
__device__ __forceinline__ int header_checksum(int h0, int h1) {
  auto a = [&](int i) { return (h0 >> (4 + i)) & 1; };
  auto b = [&](int i) { return (h0 >> i) & 1; };
  auto c = [&](int i) { return (h1 >> i) & 1; };
  int r = (a(0) ^ a(1) ^ a(2) ^ a(3)) << 4;
  r |= (a(3) ^ b(1) ^ b(2) ^ b(3) ^ c(0)) << 3;
  r |= (a(2) ^ b(0) ^ b(3) ^ c(1) ^ c(3)) << 2;
  r |= (a(1) ^ b(0) ^ b(2) ^ c(0) ^ c(1) ^ c(2)) << 1;
  r |= a(0) ^ b(1) ^ c(0) ^ c(1) ^ c(2) ^ c(3);
  return r;
}

// The Gray map with half-LSB rounding of the plain route, in its int64
// arithmetic: gray((s + half) >> shift), the shift arithmetic.
__device__ __forceinline__ long long gray_map(long long s, long long half,
                                              int shift) {
  const long long x =
      (long long)((unsigned long long)s + (unsigned long long)half) >> shift;
  return x ^ (x >> 1);
}

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(const T* __restrict__ sym, const DecodeGeo g,
              const long long* __restrict__ dec_g,
              const long long* __restrict__ whiten_g, int whiten_len,
              const long long* __restrict__ crc_g,
              const long long* __restrict__ mask_g,
              unsigned char* __restrict__ data, int* __restrict__ ints,
              bool* __restrict__ crc_out) {
  const long long r0 = (long long)blockIdx.x * g.frames;
  const int nf = (int)(g.B - r0 < g.frames ? g.B - r0 : g.frames);
  const int tid = threadIdx.x;

  if (!g.interleaving) {  // the Gray-mapped symbols pass through, int32
    int* out = reinterpret_cast<int*>(data) + r0 * g.S;
    const long long n = (long long)nf * g.S;
#pragma unroll 4
    for (long long e = tid; e < n; e += kDecThreads) {
      const long long f = e / g.S, k = e - f * g.S;
      const long long s = (long long)sym[(r0 + f) * g.rs + k * g.cs];
      out[e] = (int)gray_map(s, g.half, g.shift);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* stile = reinterpret_cast<uint16_t*>(smem);
  unsigned char* ctile = smem + g.off_cw;
  unsigned char* btile = smem + g.off_bytes;
  uint16_t* crc_t = reinterpret_cast<uint16_t*>(smem + g.off_crc);
  unsigned char* dec = smem + g.off_dec;
  unsigned char* wz = smem + g.off_wz;
  unsigned char* vmask = smem + g.off_mask;

  // ---- A: tables and Gray-mapped symbols into shared memory ---------------
  for (int e = tid; e < 5 * kRate; e += kDecThreads)
    dec[e] = (unsigned char)__ldg(dec_g + e);
  for (int e = tid; e < 256; e += kDecThreads)
    crc_t[e] = (uint16_t)__ldg(crc_g + e);
  for (int e = tid; e < g.M + 2; e += kDecThreads)
    vmask[e] = (unsigned char)__ldg(mask_g + e);
  // the whitening value of payload position p (codeword start + p): the
  // header block's stream at rate 4/8, the rest at the configured rate
  for (int p = tid; p < g.n_pay; p += kDecThreads) {
    const int rate = (p + g.start) < g.ppm ? kHeaderRdd : g.rdd;
    const long long w = __ldg(whiten_g + (rate == 1 ? whiten_len : 0) + p);
    wz[p] = (unsigned char)(w & ((1 << (4 + rate)) - 1));
  }
  {
    const int n = nf * g.K;
#pragma unroll 8
    for (int e = tid; e < n; e += kDecThreads) {
      const int f = e / g.K, k = e - f * g.K;
      const long long s = (long long)sym[(r0 + f) * g.rs + k * g.cs];
      stile[f * g.sst + k] = (uint16_t)gray_map(s, g.half, g.shift);
    }
  }
  __syncthreads();

  // ---- B: every codeword of the block's frames ----------------------------
  {
    const int n = nf * g.ncw;
    for (int e = tid; e < n; e += kDecThreads) {
      const int f = e / g.ncw, i = e - f * g.ncw;
      const int b = i / g.ppm, r = i - b * g.ppm;
      int cw = 0;
      if (b < g.nexist) {
        const int nb = b == 0 ? kHeaderSymbols : g.nbits;
        const int base = b == 0 ? 0 : kHeaderSymbols + (b - 1) * g.nbits;
        const uint16_t* row = stile + f * g.sst;
        // bit k of the codeword is bit (r - k) mod ppm of symbol k
        int m = r;
        for (int k = 0; k < nb; ++k) {
          const int idx = base + k;
          const int s = idx < g.K ? row[idx] : 0;
          cw |= ((s >> m) & 1) << k;
          m = m == 0 ? g.ppm - 1 : m - 1;
        }
      }
      if (i >= g.start) cw ^= wz[i - g.start];
      ctile[f * g.cst + i] = (unsigned char)cw;
    }
  }
  __syncthreads();

  // ---- C: one thread a frame ---------------------------------------------
  if (tid < nf) {
    const unsigned char* c = ctile + tid * g.cst;
    unsigned char* bt = btile + tid * g.bst;
    int herr = 0, hbad = 0, crc_present, rdd, pl, dl, check_crc, unmask;
    if (g.explicit_header) {
      int nib[kHeaderCodewords];
#pragma unroll
      for (int i = 0; i < kHeaderCodewords; ++i) {
        const int p = dec[kHeaderRdd * kRate + c[i]];
        nib[i] = p & 0xF;
        herr |= (p >> 4) & 1;
        hbad += (p >> 5) & 1;
      }
      const int b0 = (nib[0] << 4) | nib[1], b1 = nib[2];
      const int b2 = ((nib[3] << 4) | nib[4]) ^ header_checksum(b0, b1);
      bt[0] = (unsigned char)b0;
      bt[1] = (unsigned char)b1;
      bt[2] = (unsigned char)b2;
      crc_present = b1 & 1;
      rdd = (b1 >> 1) & 0x7;
      pl = b0;
      dl = pl + (crc_present ? 5 : 3);
      check_crc = crc_present & g.crc_check;
      unmask = crc_present;
    } else {
      crc_present = g.crc_check;
      rdd = g.rdd;
      pl = g.data_length;
      dl = pl + (g.crc_check ? 2 : 0);
      check_crc = g.crc_check;
      unmask = g.crc_check;
    }

    // payload FEC: the first block at 4/8, the rest at the announced rate
    // (a rate above 4/8 reads as nibble 0, no error, not bad); the error
    // mask of the reference's loop bounds: the first block, the odd
    // nibble straggler, then 2 codewords a byte up to dataLength
    const long long pair_end =
        (long long)g.n1 +
        2 * (long long)max(dl - (g.d_ofs0 + g.n1) / 2, 0);
    int fec_err = 0, fec_errors = 0, bad = hbad, lo = 0;
    for (int j = 0; j < g.n_pay; ++j) {
      const int cw = c[g.start + j];
      int p, bd;
      if (j < g.n0) {
        p = dec[kHeaderRdd * kRate + cw];
        bd = (p >> 5) & 1;
      } else {
        p = rdd <= kHeaderRdd ? dec[rdd * kRate + cw] : 0;
        bd = rdd == kHeaderRdd ? (p >> 5) & 1 : 0;
      }
      const int e = (p >> 4) & 1;
      const bool in_mask = j < g.n0 || (j >= g.n1 && j < pair_end) ||
                           (g.straggler && j == g.n0);
      if (in_mask) {
        fec_err |= e;
        fec_errors += e;
        bad += bd;
      }
      const int q = g.hb + (j >> 1);
      if (j & 1) {
        if (q < g.M) bt[q] = (unsigned char)(lo | ((p & 0xF) << 4));
      } else {
        lo = p & 0xF;
      }
    }
    if (g.n_pay & 1) {
      const int q = g.hb + (g.n_pay >> 1);
      if (q < g.M) bt[q] = (unsigned char)lo;
    }

    // CRC16 over the payload bytes (the header's three bytes skipped), a
    // table step a byte; the masking register read at the length
    const int n = min(max(pl, 0), g.M);
    unsigned res = 0;
    for (int i = 0; i < n; ++i) {
      const int pos = i + g.hb;
      const unsigned d = pos < g.M ? bt[pos] : 0u;
      res = ((res << 8) & 0xFFFFu) ^ crc_t[(res >> 8) & 0xFF] ^ d;
    }
    const int crc =
        (int)((res ^ vmask[n] ^ ((unsigned)vmask[n + 1] << 8)) & 0xFFFFu);
    const long long lo_pos = (long long)g.hb + pl, hi_pos = lo_pos + 1;
    const int pkt_crc = bt[floor_mod(lo_pos, g.M)] |
                        (bt[floor_mod(hi_pos, g.M)] << 8);
    if (unmask) {
      if (lo_pos >= 0 && lo_pos < g.M) bt[lo_pos] ^= (unsigned char)(crc & 0xFF);
      if (hi_pos >= 0 && hi_pos < g.M) bt[hi_pos] ^= (unsigned char)(crc >> 8);
    }

    int status = kOk;
    if (g.explicit_header) {
      if (g.error_check && herr) status = kDropHeaderFec;
      else if (rdd > kHeaderRdd) status = kDropHeaderRdd;
    }
    if (status == kOk && dl > g.M) status = kDropLength;
    if (status == kOk && g.error_check && fec_err) status = kDropFec;
    if (status == kOk && check_crc && pkt_crc != crc) status = kDropCrc;

    const bool cut = g.explicit_header && !g.hdr;
    const long long row = r0 + tid;
    ints[0 * g.B + row] = cut ? 3 : 0;        // offset
    ints[1 * g.B + row] = cut ? dl - 5 : dl;  // length
    ints[2 * g.B + row] = status;
    ints[3 * g.B + row] = pl;                 // packet_length
    ints[4 * g.B + row] = rdd;
    ints[5 * g.B + row] = fec_errors;
    ints[6 * g.B + row] = bad;
    crc_out[row] = crc_present != 0;
  }
  __syncthreads();

  // ---- D: the block's bytes, one contiguous run of the output -------------
  {
    unsigned char* out = data + r0 * g.M;
    const int n = nf * g.M;
    for (int e = tid; e < n; e += kDecThreads) {
      const int f = e / g.M, q = e - f * g.M;
      out[e] = btile[f * g.bst + q];
    }
  }
}

// A row stride of at least n bytes that is an odd number of 4-byte words.
static int odd_words(int n) {
  int w = (n + 3) / 4;
  if (w % 2 == 0) ++w;
  return 4 * w;
}

// Shared memory of a block of f frames; lays the tiles out in g.
static long long layout(DecodeGeo& g, int f) {
  g.frames = f;
  long long off = (long long)f * g.sst * 2;
  g.off_cw = (int)off;
  off += (long long)f * g.cst;
  g.off_bytes = (int)off;
  off += (long long)f * g.bst;
  g.off_crc = (int)off;
  off += 256 * 2;
  g.off_dec = (int)off;
  off += 5 * kRate;
  g.off_wz = (int)off;
  off += g.n_pay;
  g.off_mask = (int)off;
  off += g.M + 2;
  return off;
}

template <typename T>
int launch_decode(const void* sym, DecodeGeo g, const void* dec,
                  const void* whiten, int whiten_len, const void* crc16,
                  const void* crc_mask, void* data, void* ints,
                  void* crc_present, cudaStream_t stream) {
  size_t smem = 0;
  if (g.interleaving) {
    int f = kMaxFrames;
    long long need = layout(g, f);
    while (need > kMaxSmem && f > 1) need = layout(g, f /= 2);
    if (need > kMaxSmem) return (int)cudaErrorInvalidValue;
    smem = (size_t)need;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
  } else {
    g.frames = kMaxFrames;
  }
  const long long blocks = (g.B + g.frames - 1) / g.frames;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  decode_kernel<T><<<(unsigned)blocks, kDecThreads, smem, stream>>>(
      static_cast<const T*>(sym), g, static_cast<const long long*>(dec),
      static_cast<const long long*>(whiten), whiten_len,
      static_cast<const long long*>(crc16),
      static_cast<const long long*>(crc_mask),
      static_cast<unsigned char*>(data), static_cast<int*>(ints),
      static_cast<bool*>(crc_present));
  return (int)cudaGetLastError();
}

}  // namespace lora

// sym: B rows of S integer symbols, element (r, k) at sym + r*rs + k*cs, of
// dtype 0 uint8, 1 int8, 2 int16, 3 int32, 4 int64.  The static
// configuration as LoRaConfig gives it (ppm is its PPM, rdd its coding
// rate); ncw, nexist and K the call's geometry, as ops/cuda_decode.py's
// geometry() forms and checks it (M = (ncw + 1) / 2 bytes a frame).
// Tables, int64 on the card, from ops/tables.py through ops/codes.lut: dec
// [5 * 256] (the FEC decode of every rate), whiten [2, whiten_len], crc16
// [256], crc_mask [M + 2].  Outputs: data uint8 [B, M], ints int32 [7, B]
// (offset, length, status, packet_length, rdd, fec_errors, bad),
// crc_present bool [B]; with interleaving 0, data is int32 [B, S], the
// Gray-mapped symbols, and the geometry, the tables and the other outputs
// are not read.  A geometry outside what the kernel can index returns
// cudaErrorInvalidValue.  Returns a CUDA error code.
extern "C" int lora_decode(const void* sym, int dtype, long long B, int S,
                           long long rs, long long cs, int sf, int ppm,
                           int rdd, int explicit_header, int hdr,
                           int crc_check, int error_check, int interleaving,
                           int data_length, int ncw, int nexist, int K,
                           const void* dec, const void* whiten,
                           int whiten_len, const void* crc16,
                           const void* crc_mask, void* data, void* ints,
                           void* crc_present, void* stream) {
  using namespace lora;
  if (B == 0 || S == 0) return 0;
  if (ppm < 1 || ppm > sf || sf - ppm > 30 || rdd < 0 || rdd > 4)
    return (int)cudaErrorInvalidValue;
  DecodeGeo g = {};
  g.B = B;
  g.rs = rs;
  g.cs = cs;
  g.S = S;
  g.shift = sf - ppm;
  g.half = (1LL << g.shift) / 2;
  g.ppm = ppm;
  g.rdd = rdd;
  g.nbits = 4 + rdd;
  g.explicit_header = explicit_header != 0;
  g.hdr = hdr != 0;
  g.crc_check = crc_check != 0;
  g.error_check = error_check != 0;
  g.interleaving = interleaving != 0;
  g.data_length = data_length;
  if (g.interleaving) {
    g.ncw = ncw;
    g.nexist = nexist;
    g.K = K;
    g.start = g.explicit_header ? kHeaderCodewords : 0;
    g.n_pay = g.ncw - g.start;
    g.n0 = ppm - g.start;
    g.d_ofs0 = g.explicit_header ? 2 * 3 : 0;
    g.straggler = floor_mod(g.d_ofs0 + g.n0, 2);
    g.n1 = g.n0 + g.straggler;
    g.hb = g.explicit_header ? 3 : 0;
    g.M = (g.ncw + 1) / 2;
    if (g.ncw < 1 || g.n_pay < 0 || g.n_pay > whiten_len || nexist < 1 ||
        (long long)nexist * ppm > ncw || K < 1 || K > S)
      return (int)cudaErrorInvalidValue;
    g.sst = odd_words(2 * g.K) / 2;
    g.cst = odd_words(g.ncw);
    g.bst = odd_words(g.M);
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_decode<uint8_t>(sym, g, dec, whiten, whiten_len, crc16,
                                    crc_mask, data, ints, crc_present, st);
    case 1:
      return launch_decode<int8_t>(sym, g, dec, whiten, whiten_len, crc16,
                                   crc_mask, data, ints, crc_present, st);
    case 2:
      return launch_decode<int16_t>(sym, g, dec, whiten, whiten_len, crc16,
                                    crc_mask, data, ints, crc_present, st);
    case 3:
      return launch_decode<int32_t>(sym, g, dec, whiten, whiten_len, crc16,
                                    crc_mask, data, ints, crc_present, st);
    case 4:
      return launch_decode<long long>(sym, g, dec, whiten, whiten_len, crc16,
                                      crc_mask, data, ints, crc_present, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
