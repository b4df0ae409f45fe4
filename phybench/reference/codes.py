"""The LoRa bit codecs of the plain reference: FEC, Gray maps, whitening,
the diagonal interleaver, the header checksum and the payload CRC16.

A frozen copy of lora_tpu_torch/ops/_bitref.py (the scalar codecs that
build the tables), lora_tpu_torch/ops/tables.py (the tables) and
lora_tpu_torch/ops/codes.py (the vectorised codecs over int tensors).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

HEADER_RDD = 4


# -- scalar codecs (from lora_tpu_torch/ops/_bitref.py) ----------------------

def _bit(x: int, i: int) -> int:
    return (x >> i) & 1


def _enc84(x: int) -> int:
    d0, d1, d2, d3 = (_bit(x, i) for i in range(4))
    return ((x & 0xF) | (d0 ^ d1 ^ d2) << 4 | (d1 ^ d2 ^ d3) << 5
            | (d0 ^ d1 ^ d3) << 6 | (d0 ^ d2 ^ d3) << 7)


def _dec84(b: int) -> tuple[int, bool, bool]:
    bits = [(b >> i) & 1 for i in range(8)]
    p0 = bits[0] ^ bits[1] ^ bits[2] ^ bits[4]
    p1 = bits[1] ^ bits[2] ^ bits[3] ^ bits[5]
    p2 = bits[0] ^ bits[1] ^ bits[3] ^ bits[6]
    p3 = bits[0] ^ bits[2] ^ bits[3] ^ bits[7]
    parity = p0 | (p1 << 1) | (p2 << 2) | (p3 << 3)
    flip = {0xD: 1, 0x7: 2, 0xB: 4, 0xE: 8}
    if parity in flip:
        return (b ^ flip[parity]) & 0xF, True, False
    return b & 0xF, parity != 0, parity not in (0x0, 0x1, 0x2, 0x4, 0x8)


def _enc74(x: int) -> int:
    d0, d1, d2, d3 = (_bit(x, i) for i in range(4))
    return ((x & 0xF) | (d0 ^ d1 ^ d2) << 4 | (d1 ^ d2 ^ d3) << 5
            | (d0 ^ d1 ^ d3) << 6)


def _dec74(b: int) -> tuple[int, bool]:
    bits = [(b >> i) & 1 for i in range(7)]
    p0 = bits[0] ^ bits[1] ^ bits[2] ^ bits[4]
    p1 = bits[1] ^ bits[2] ^ bits[3] ^ bits[5]
    p2 = bits[0] ^ bits[1] ^ bits[3] ^ bits[6]
    parity = p0 | (p1 << 1) | (p2 << 2)
    flip = {0x5: 1, 0x7: 2, 0x3: 4, 0x6: 8}
    return (b ^ flip.get(parity, 0)) & 0xF, parity != 0


def _enc54(b: int) -> int:
    x = b ^ (b >> 2)
    x = x ^ (x >> 1)
    return (b & 0xF) | ((x << 4) & 0x10)


def _chk54(b: int) -> tuple[int, bool]:
    x = b ^ (b >> 2)
    x = x ^ (x >> 1) ^ (b >> 4)
    return b & 0xF, bool(x & 1)


def _enc64(b: int) -> int:
    x = b ^ (b >> 1) ^ (b >> 2)
    y = x ^ b ^ (b >> 3)
    return ((x & 1) << 4) | ((y & 1) << 5) | (b & 0xF)


def _chk64(b: int) -> tuple[int, bool]:
    x = b ^ (b >> 1) ^ (b >> 2)
    y = x ^ b ^ (b >> 3)
    x ^= b >> 4
    y ^= b >> 5
    return b & 0xF, bool((x | y) & 1)


_LFSR_SEEDS = {False: (0x6572D100E85C2EFF, 0xE85C2EFFFFFFFFFF),
               True: (0x05121100F8ECFEEF, 0xF8ECFEEFEFEFEFEF)}
_MASK64 = (1 << 64) - 1


def _whitening_sequence(length: int, rdd1_mode: bool) -> list[int]:
    r = list(_LFSR_SEEDS[rdd1_mode])
    out = []
    for i in range(length):
        out.append(r[i & 1] & 0xFF)
        x = r[i & 1]
        fb = ((x >> 32) ^ (x >> 24) ^ (x >> 16) ^ x) & _MASK64
        r[i & 1] = ((x >> 8) | (fb << 56)) & _MASK64
    return out


def _crc16_shift8(crc: int, poly: int = 0x1021) -> int:
    for _ in range(8):
        crc = ((crc << 1) ^ poly) & 0xFFFF if crc & 0x8000 \
            else (crc << 1) & 0xFFFF
    return crc


def _xsum8(t: int) -> int:
    t ^= t >> 4
    t ^= t >> 2
    t ^= t >> 1
    return t & 1


# -- tables (from lora_tpu_torch/ops/tables.py) ------------------------------

def _enc_luts() -> np.ndarray:
    t = np.zeros((5, 16), np.int64)
    for n in range(16):
        t[:, n] = (n, _enc54(n), _enc64(n), _enc74(n), _enc84(n))
    return t


def _dec_luts() -> np.ndarray:
    """[rdd, codeword] -> nibble | error << 4 | bad << 5."""
    t = np.zeros((5, 256), np.int64)
    for c in range(256):
        t[0, c] = c & 0xF
        v, e = _chk54(c & 0x1F)
        t[1, c] = v | (int(e) << 4)
        v, e = _chk64(c & 0x3F)
        t[2, c] = v | (int(e) << 4)
        v, e = _dec74(c & 0x7F)
        t[3, c] = v | (int(e) << 4)
        v, e, b = _dec84(c)
        t[4, c] = v | (int(e) << 4) | (int(b) << 5)
    return t


def _crc_whitening(n: int) -> np.ndarray:
    v = [0xFF]
    for _ in range(n):
        v.append((_xsum8(v[-1] & 0xB8) | (v[-1] << 1)) & 0xFF)
    return np.array(v, np.int64)


_TABLES = {
    "enc": _enc_luts,
    "dec": _dec_luts,
    "whiten": lambda: np.array([_whitening_sequence(2048, False),
                                _whitening_sequence(2048, True)], np.int64),
    "crc16": lambda: np.array([_crc16_shift8(h << 8) for h in range(256)],
                              np.int64),
    "crc_whitening": lambda: _crc_whitening(1024),
}


@functools.lru_cache(maxsize=None)
def lut(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_TABLES[name](), dtype=torch.int64, device=device)


# -- vectorised codecs (from lora_tpu_torch/ops/codes.py) --------------------

def binary_to_gray(x: torch.Tensor) -> torch.Tensor:
    return x ^ (x >> 1)


def gray_to_binary(x: torch.Tensor) -> torch.Tensor:
    for s in (8, 4, 2, 1):
        x = x ^ (x >> s)
    return x


def fec_encode(nibbles: torch.Tensor, rdd: int) -> torch.Tensor:
    return lut("enc", nibbles.device)[rdd][nibbles.long()]


def fec_decode(codewords: torch.Tensor, rdd):
    """-> (nibble, error, bad); rdd an int or an int tensor (a corrupt
    header's rdd 5..7 reads nibble 0, no error, not bad)."""
    cw = codewords.long()
    dec = lut("dec", cw.device)
    if isinstance(rdd, int):
        packed = dec[rdd][cw]
    else:
        flat = dec.reshape(-1)
        idx = rdd.long() * 256 + cw
        inside = idx < flat.numel()
        packed = torch.where(inside, flat[torch.where(inside, idx, 0)], 0)
    return packed & 0xF, (packed >> 4) & 1, (packed >> 5) & 1


def whiten(codewords: torch.Tensor, bit_ofs: int, rdd) -> torch.Tensor:
    n = codewords.shape[-1]
    seq = lut("whiten", codewords.device)[:, bit_ofs : bit_ofs + n]
    if isinstance(rdd, int):
        stream = seq[1 if rdd == 1 else 0]
    else:
        stream = torch.where(rdd == 1, seq[1], seq[0])
    return codewords ^ (stream & ((1 << (4 + rdd)) - 1))


def interleave(codewords: torch.Tensor, ppm: int, rdd: int) -> torch.Tensor:
    """codewords [..., nblocks*ppm] -> symbols [..., nblocks*(4+rdd)]."""
    nbits = 4 + rdd
    *lead, ncw = codewords.shape
    nblocks = ncw // ppm
    cw = codewords[..., : nblocks * ppm].reshape(*lead, nblocks, ppm).long()
    dev = cw.device
    kk = torch.arange(nbits, device=dev)
    bits = (cw[..., :, :, None] >> kk) & 1
    idx = (torch.arange(ppm, device=dev)[None, :] + kk[:, None]) % ppm
    sym_bits = bits[..., idx, kk[:, None]]
    weights = 1 << torch.arange(ppm, device=dev)
    return (sym_bits * weights).sum(-1).reshape(*lead, nblocks * nbits)


def deinterleave(symbols: torch.Tensor, ppm: int, rdd: int) -> torch.Tensor:
    """symbols [..., nblocks*(4+rdd)] -> codewords [..., nblocks*ppm]."""
    nbits = 4 + rdd
    *lead, nsym = symbols.shape
    nblocks = nsym // nbits
    sym = symbols[..., : nblocks * nbits].reshape(*lead, nblocks, nbits).long()
    dev = sym.device
    mm = torch.arange(ppm, device=dev)
    sym_bits = (sym[..., :, :, None] >> mm) & 1
    kk = torch.arange(nbits, device=dev)
    m_idx = (mm[:, None] - kk[None, :]) % ppm
    cw_bits = sym_bits[..., kk[None, :], m_idx]
    return (cw_bits * (1 << kk)).sum(-1).reshape(*lead, nblocks * ppm)


def header_checksum(h0: torch.Tensor, h1: torch.Tensor) -> torch.Tensor:
    a = [(h0 >> (4 + i)) & 1 for i in range(4)]
    b = [(h0 >> i) & 1 for i in range(4)]
    c = [(h1 >> i) & 1 for i in range(4)]
    res = (a[0] ^ a[1] ^ a[2] ^ a[3]) << 4
    res |= (a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3
    res |= (a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2
    res |= (a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1
    res |= a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3]
    return res


def crc16_step(res: torch.Tensor, byte: torch.Tensor) -> torch.Tensor:
    t = lut("crc16", res.device)
    return ((res << 8) & 0xFFFF) ^ t[(res >> 8) & 0xFF] ^ byte


def crc16_finish(res: torch.Tensor, n) -> torch.Tensor:
    v = lut("crc_whitening", res.device)
    return (res ^ v[n] ^ (v[n + 1] << 8)) & 0xFFFF


def data_checksum(data: torch.Tensor) -> torch.Tensor:
    """The payload CRC16 over bytes [..., L]."""
    data = data.long()
    res = torch.zeros(data.shape[:-1], dtype=torch.int64, device=data.device)
    for i in range(data.shape[-1]):
        res = crc16_step(res, data[..., i])
    return crc16_finish(res, data.shape[-1])


def masked_crc16(data: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """CRC16 over data[..., :length] with a per-packet length."""
    data = data.long()
    L = data.shape[-1]
    active = torch.arange(L, device=data.device) < length[..., None]
    res = torch.zeros(data.shape[:-1], dtype=torch.int64, device=data.device)
    for i in range(L):
        res = torch.where(active[..., i], crc16_step(res, data[..., i]), res)
    return crc16_finish(res, torch.clamp(length, 0, L).long())
