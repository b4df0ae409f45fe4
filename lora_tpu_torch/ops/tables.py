"""Constant tables of the PHY, in numpy only.

The JAX package builds these tables inside modules that import jax
(`lora_tpu/ops/codes.py`, `chirp.py`, `fft.py`, `pallas_demod.py`,
`channelizer.py`, `pallas_channelize.py`); the port
rebuilds the same values here so that neither it nor the machines it runs on
need jax.  The scalar bit-level codecs come from the port's own
`ops/_bitref.py`.

`tests/test_torch_tables.py` holds every table against the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np

from . import _bitref as bitref

# --------------------------------------------------------------------------
# codec LUTs (lora_tpu/ops/codes.py:33-62)
# --------------------------------------------------------------------------


def _enc_luts() -> np.ndarray:
    """[rdd, nibble] -> codeword."""
    t = np.zeros((5, 16), np.int32)
    for n in range(16):
        t[0, n] = n
        t[1, n] = bitref.encode_parity54(n)
        t[2, n] = bitref.encode_parity64(n)
        t[3, n] = bitref.encode_hamming74(n)
        t[4, n] = bitref.encode_hamming84(n)
    return t


def _dec_luts() -> np.ndarray:
    """[rdd, codeword] -> nibble | error << 4 | bad << 5."""
    t = np.zeros((5, 256), np.int32)
    for c in range(256):
        t[0, c] = c & 0xF
        v, e = bitref.check_parity54(c & 0x1F)
        t[1, c] = v | (int(e) << 4)
        v, e = bitref.check_parity64(c & 0x3F)
        t[2, c] = v | (int(e) << 4)
        v, e = bitref.decode_hamming74(c & 0x7F)
        t[3, c] = v | (int(e) << 4)
        v, e, b = bitref.decode_hamming84(c)
        t[4, c] = v | (int(e) << 4) | (int(b) << 5)
    return t


ENC_LUTS = _enc_luts()
DEC_LUTS = _dec_luts()

# whitening streams [mode, position]; mode 1 is the rdd == 1 stream.  2048
# positions cover the longest frame (255 B + CRC -> <= 2*257 + 5 + PPM).
WHITEN_LEN = 2048
WHITEN_SEQ = np.stack([
    np.asarray(bitref.whitening_sequence(WHITEN_LEN, rdd1_mode=False), np.int32),
    np.asarray(bitref.whitening_sequence(WHITEN_LEN, rdd1_mode=True), np.int32),
])


@functools.lru_cache(maxsize=None)
def crc16_table() -> np.ndarray:
    """T[h] = 8 steps of the 0x1021 shift register from h << 8, int32 [256].
    The register is linear, so 8 steps from any 16-bit res are one table
    step: ((res << 8) & 0xFFFF) ^ T[res >> 8] (the low byte only moves up)."""
    return np.array([bitref._crc16_shift8(h << 8) for h in range(256)],
                    np.int32)


@functools.lru_cache(maxsize=None)
def crc_whitening(n: int) -> np.ndarray:
    """V[i] for i in [0, n]: the payload CRC's 8-bit masking register after
    i bytes, from 0xFF (LoRaCodes.hpp:80-93).  It does not depend on the
    data, so the register after a packet of L bytes is V[L], and the CRC's
    last step reads V[L + 1]."""
    v = [0xFF]
    for _ in range(n):
        v.append((bitref._xsum8(v[-1] & 0xB8) | (v[-1] << 1)) & 0xFF)
    return np.array(v, np.int32)


def binary_to_gray_np(x: np.ndarray) -> np.ndarray:
    """Gray map (lora_tpu/ops/codes.py:69-70)."""
    return x ^ (x >> 1)


@functools.lru_cache(maxsize=None)
def interleave_gather(ppm: int, rdd: int) -> np.ndarray:
    """idx[k, m] = (m + k) % ppm: symbol k takes bit k of codeword idx[k, m]
    into bit position m (lora_tpu/ops/codes.py:131)."""
    k = np.arange(4 + rdd)[:, None]
    m = np.arange(ppm)[None, :]
    return ((m + k) % ppm).astype(np.int32)


@functools.lru_cache(maxsize=None)
def deinterleave_gather(ppm: int, rdd: int) -> np.ndarray:
    """m_idx[i, k] = (i - k) % ppm: codeword i bit k is symbol k bit m."""
    i = np.arange(ppm)[:, None]
    k = np.arange(4 + rdd)[None, :]
    return ((i - k) % ppm).astype(np.int32)


@functools.lru_cache(maxsize=None)
def bin_word_gather(sf: int, ppm: int) -> np.ndarray:
    """idx[w, j] = the FFT bins whose hard decode is the Gray-mapped word w,
    int32 [2^ppm, width], short rows padded by repeating their last bin (a
    max over the row is a max over the true set); ppm == sf leaves one bin
    per word (lora_tpu/models/softdec.py:61-74)."""
    N = 1 << sf
    shift = sf - ppm
    half = (1 << shift) // 2
    q = (np.arange(N) + half) >> shift
    w = binary_to_gray_np(q) & ((1 << ppm) - 1)
    groups = [np.nonzero(w == ww)[0] for ww in range(1 << ppm)]
    width = max(len(g) for g in groups)
    idx = np.stack([np.pad(g, (0, width - len(g)), mode="edge")
                    for g in groups])
    return idx.astype(np.int32)


# --------------------------------------------------------------------------
# chirp and DFT tables (lora_tpu/ops/chirp.py:111-137, fft.py:33-45)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def dechirp_turns_np(N: int, down: bool) -> np.ndarray:
    """Dechirp multiplier phase (turns): the conjugate of the base (s=0) up
    chirp for down=False, the up chirp itself for down=True."""
    i1 = np.arange(1, N + 1, dtype=np.int64)
    w = np.maximum(0, i1 + 1 - N)
    num = (i1 * (N // 2) * (-1) + i1 * (i1 + 1) // 2 - N * w) % N
    turns = (num / N) % 1.0
    if not down:
        turns = (-turns) % 1.0
    return turns.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dechirp_table_np(N: int, down: bool) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) float32 [N] of the dechirp multiplier."""
    t = 2 * np.pi * dechirp_turns_np(N, down).astype(np.float64)
    return np.cos(t).astype(np.float32), np.sin(t).astype(np.float32)


@functools.lru_cache(maxsize=None)
def dft_matrix_np(n: int) -> tuple[np.ndarray, np.ndarray]:
    k = np.arange(n)
    ang = -2 * np.pi / n * np.outer(k, k)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def twiddle_np(n1: int, n2: int) -> tuple[np.ndarray, np.ndarray]:
    k1 = np.arange(n1)[:, None]
    n2i = np.arange(n2)[None, :]
    ang = -2 * np.pi / (n1 * n2) * (k1 * n2i)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def fft_twiddles_np(N: int) -> np.ndarray:
    """exp(-2*pi*i*k/N) for k < N/2 as interleaved float32 [N/2, 2]: the
    radix-2 twiddles of the CUDA kernels, row 1 of twiddle_np(2, N/2)."""
    re, im = twiddle_np(2, N // 2)
    return np.ascontiguousarray(np.stack([re[1], im[1]], axis=-1))


# --------------------------------------------------------------------------
# demodulator geometry (lora_tpu/ops/pallas_demod.py:61-170).  The JAX
# package pads its buffers and clips data_start by these helpers, so the
# port must reproduce them for T, consumed and payload_complete to agree.
# --------------------------------------------------------------------------

N_SCAN = 13                  # MAX_SYNC_SEARCH: aligned windows scanned for sync
N_TRACK_WIN = N_SCAN + 4     # scan + 2 downchirps + quarter margin
TRACK_ROWS = N_TRACK_WIN + 1

_FLAT_MAX = 1 << 18


@functools.lru_cache(maxsize=None)
def payload_geometry(N: int, mtu: int) -> tuple[int, int, int]:
    """(windows_per_tile, tiles, gathered_rows) of the tiled payload route."""
    cap = max(8, min(128, (1 << 19) // (N * 4)))
    m = mtu // 8 + 1
    best = max(d for d in range(1, m + 1) if m % d == 0 and 8 * d <= cap)
    twm = 8 * best
    tiles = m // best
    rp = 8 * m if tiles == 1 else 8 * m + 8
    return twm, tiles, rp


@functools.lru_cache(maxsize=None)
def payload_flat_geometry(N: int, mtu: int) -> tuple[int, int] | None:
    """(rows_per_channel, channels_per_cell) of the flat payload route, or
    None when one channel's rows exceed its block budget."""
    rp = 8 * (mtu // 8 + 1)
    if rp * N > _FLAT_MAX:
        return None
    pc = max(1, min(1024 // rp, _FLAT_MAX // (rp * N)))
    return rp, pc


def payload_rows(N: int, mtu: int) -> int:
    """Aligned rows each channel's payload stage spans (>= mtu + 1)."""
    flat = payload_flat_geometry(N, mtu)
    if flat is not None:
        return flat[0]
    return payload_geometry(N, mtu)[2]


# --------------------------------------------------------------------------
# polyphase channelizer constants (lora_tpu/ops/channelizer.py:38-140,
# pallas_channelize.py:263-293)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def prototype(K: int, taps_per_phase: int = 8, beta: float = 8.0) -> np.ndarray:
    """Kaiser lowpass prototype, length K*taps_per_phase, passband 0.5/K
    of the wideband rate, unit DC gain per channel."""
    L = K * taps_per_phase
    n = np.arange(L) - (L - 1) / 2
    h = np.sinc(n / K) * np.kaiser(L, beta)
    return (h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def idft_k(K: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) float32 [K, K] of e^{+2 pi i p k / K}, rounded from
    float64."""
    p = np.arange(K)
    ang = 2 * np.pi / K * np.outer(p, p)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def fir_idft_matrix(K: int, taps_per_phase: int,
                    G: int) -> tuple[np.ndarray, np.ndarray]:
    """[(L+G-1)*K, G*K] analysis-bank matrix giving G consecutive channel
    samples per grouped row: WB[(r, p), (j, k)] = H[j+L-1-r, p] * W[p, k]
    for 0 <= j+L-1-r < L."""
    L = taps_per_phase
    H = prototype(K, taps_per_phase).reshape(L, K).astype(np.float64)
    wre, wim = idft_k(K)
    W = wre.astype(np.float64) + 1j * wim.astype(np.float64)  # [p, k]
    R = L + G - 1
    wb = np.zeros((R, K, G, K), np.complex128)
    for r in range(R):
        for j in range(G):
            l = j + L - 1 - r
            if 0 <= l < L:
                wb[r, :, j, :] = H[l][:, None] * W
    wb = wb.reshape(R * K, G * K)
    return wb.real.astype(np.float32), wb.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def fir_dft_syn_matrix(K: int, taps_per_phase: int,
                       G: int) -> tuple[np.ndarray, np.ndarray]:
    """[(L+G-1)*K, G*K] synthesis-bank matrix giving G*K consecutive
    wideband samples per grouped row of channel samples:
    WS[(r, k), (j, p)] = E[k, p] * K*h[(j-r+L-1)*K + p] for
    0 <= j-r+L-1 < L."""
    L = taps_per_phase
    Gh = (prototype(K, taps_per_phase).astype(np.float64) * K).reshape(L, K)
    ere, eim = idft_k(K)
    E = ere.astype(np.float64) + 1j * eim.astype(np.float64)  # [k, p]
    R = L + G - 1
    ws = np.zeros((R, K, G, K), np.complex128)
    for r in range(R):
        for j in range(G):
            l = j - r + L - 1
            if 0 <= l < L:
                ws[r, :, j, :] = E * Gh[l][None, :]
    ws = ws.reshape(R * K, G * K)
    return ws.real.astype(np.float32), ws.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def fir_taps_flipped(K: int, taps_per_phase: int) -> np.ndarray:
    """float32 [L, K] polyphase taps with the commutator's lane flip folded
    in: hp[l, q] = h[l*K + K-1-q] (the `hp` rows of
    pallas_channelize._fir_idft_consts, without its zero padding)."""
    H = prototype(K, taps_per_phase).reshape(taps_per_phase, K)
    return np.ascontiguousarray(H[:, ::-1])


# --------------------------------------------------------------------------
# fractional resampler bank (lora_tpu/ops/resample.py:28-47)
# --------------------------------------------------------------------------

RESAMPLE_PHASES = 128
RESAMPLE_TAPS = 8


@functools.lru_cache(maxsize=None)
def resample_bank(cutoff_num: int, cutoff_den: int, taps: int,
                  beta: float = 8.0) -> np.ndarray:
    """[RESAMPLE_PHASES, taps] fractional-delay lowpass bank, float32: one
    windowed-sinc prototype of length RESAMPLE_PHASES*taps (cutoff num/den
    of the input Nyquist, Kaiser window) designed in float64 and split into
    its polyphase components; subfilter p interpolates at delay
    p/RESAMPLE_PHASES, each with unit DC gain."""
    cutoff = min(1.0, cutoff_num / cutoff_den)
    L = RESAMPLE_PHASES * taps
    n = np.arange(L) - L / 2  # integer-centred: phase 0 is an exact delta
    proto = np.sinc(cutoff * n / RESAMPLE_PHASES) * np.kaiser(L, beta)
    h = np.zeros((RESAMPLE_PHASES, taps), np.float64)
    for p in range(RESAMPLE_PHASES):
        sub = proto[p::RESAMPLE_PHASES][:taps]
        h[p, : sub.shape[0]] = sub / max(sub.sum(), 1e-9)
    return h.astype(np.float32)
