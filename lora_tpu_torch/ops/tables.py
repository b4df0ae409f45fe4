"""Constant tables of the PHY, in numpy only.

The JAX package builds these tables inside modules that import jax
(`lora_tpu/ops/codes.py`, `chirp.py`, `fft.py`, `pallas_demod.py`); the port
rebuilds the same values here so that neither it nor the machines it runs on
need jax.  The scalar bit-level codecs come from `lora_tpu/ops/_bitref.py`,
which is pure Python, loaded by file path: importing it through its package
would run `lora_tpu/ops/__init__.py`, which imports jax.

`tests/test_torch_tables.py` holds every table against the JAX package.
"""

from __future__ import annotations

import functools
import importlib.util
import pathlib

import numpy as np

import lora_tpu  # loads only lora_tpu.config (no jax)


def _load_bitref():
    path = pathlib.Path(lora_tpu.__file__).parent / "ops" / "_bitref.py"
    spec = importlib.util.spec_from_file_location("lora_tpu_torch._bitref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bitref = _load_bitref()

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
