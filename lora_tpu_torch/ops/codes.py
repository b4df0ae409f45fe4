"""Vectorised bit-domain codecs over int tensors (port of
lora_tpu/ops/codes.py): LUT FEC, Gray maps, whitening, the diagonal
interleaver, the header checksum and the payload CRC16.  Leading axes are
batch; the last axis is the codeword, nibble or byte stream."""

from __future__ import annotations

import torch

from . import tables


def _lut(table, device) -> torch.Tensor:
    return torch.as_tensor(table, dtype=torch.int64, device=device)


def binary_to_gray(x: torch.Tensor) -> torch.Tensor:
    return x ^ (x >> 1)


def gray_to_binary(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x


def fec_encode(nibbles: torch.Tensor, rdd: int) -> torch.Tensor:
    """nibbles int [..., n] in [0, 16) -> codewords int64."""
    return _lut(tables.ENC_LUTS[rdd], nibbles.device)[nibbles.long()]


def fec_decode(codewords: torch.Tensor, rdd):
    """codewords int [..., n] -> (nibble, error, bad) int64.  `rdd` is an
    int or an int tensor broadcastable against codewords (the
    header-announced rate)."""
    cw = codewords.long()
    if isinstance(rdd, int):
        packed = _lut(tables.DEC_LUTS[rdd], cw.device)[cw]
    else:
        # a corrupt header may announce rdd 5..7: the JAX gather fills those
        # lanes with INT_MIN, which unpacks to nibble 0, no error, not bad
        flat = _lut(tables.DEC_LUTS.reshape(-1), cw.device)
        idx = rdd.long() * 256 + cw
        inside = idx < flat.numel()
        packed = torch.where(inside, flat[torch.where(inside, idx, 0)], 0)
    return packed & 0xF, (packed >> 4) & 1, (packed >> 5) & 1


def whiten(codewords: torch.Tensor, bit_ofs: int, rdd) -> torch.Tensor:
    """XOR codewords [..., n] with the whitening stream from absolute
    position `bit_ofs`, masked to 4 + rdd bits; rdd may be a tensor."""
    n = codewords.shape[-1]
    seq = _lut(tables.WHITEN_SEQ[:, bit_ofs : bit_ofs + n], codewords.device)
    if isinstance(rdd, int):
        stream = seq[1 if rdd == 1 else 0]
    else:
        stream = torch.where(rdd == 1, seq[1], seq[0])
    mask = (1 << (4 + rdd)) - 1
    return codewords ^ (stream & mask)


def interleave(codewords: torch.Tensor, ppm: int, rdd: int) -> torch.Tensor:
    """codewords [..., nblocks*ppm] -> symbols [..., nblocks*(4+rdd)]."""
    nbits = 4 + rdd
    *lead, ncw = codewords.shape
    nblocks = ncw // ppm
    cw = codewords[..., : nblocks * ppm].reshape(*lead, nblocks, ppm).long()
    kk = torch.arange(nbits, device=cw.device)
    bits = (cw[..., :, :, None] >> kk) & 1              # [..., x, ppm, nbits]
    idx = _lut(tables.interleave_gather(ppm, rdd), cw.device)  # (nbits, ppm)
    sym_bits = bits[..., idx, kk[:, None]]             # [..., x, nbits, ppm]
    weights = 1 << torch.arange(ppm, device=cw.device)
    return (sym_bits * weights).sum(-1).reshape(*lead, nblocks * nbits)


def deinterleave(symbols: torch.Tensor, ppm: int, rdd: int) -> torch.Tensor:
    """symbols [..., nblocks*(4+rdd)] -> codewords [..., nblocks*ppm]."""
    nbits = 4 + rdd
    *lead, nsym = symbols.shape
    nblocks = nsym // nbits
    sym = symbols[..., : nblocks * nbits].reshape(*lead, nblocks, nbits).long()
    mm = torch.arange(ppm, device=sym.device)
    sym_bits = (sym[..., :, :, None] >> mm) & 1         # [..., x, nbits, ppm]
    m_idx = _lut(tables.deinterleave_gather(ppm, rdd), sym.device)
    kk = torch.arange(nbits, device=sym.device)
    cw_bits = sym_bits[..., kk[None, :], m_idx]         # [..., x, ppm, nbits]
    weights = 1 << kk
    return (cw_bits * weights).sum(-1).reshape(*lead, nblocks * ppm)


def header_checksum(h0: torch.Tensor, h1: torch.Tensor) -> torch.Tensor:
    """5-bit header checksum (LoRaCodes.hpp:31-55)."""
    a = [(h0 >> (4 + i)) & 1 for i in range(4)]
    b = [(h0 >> i) & 1 for i in range(4)]
    c = [(h1 >> i) & 1 for i in range(4)]
    res = (a[0] ^ a[1] ^ a[2] ^ a[3]) << 4
    res |= (a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3
    res |= (a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2
    res |= (a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1
    res |= a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3]
    return res


def crc16_shift8(crc: torch.Tensor) -> torch.Tensor:
    """8 steps of the 0x1021 shift register."""
    for _ in range(8):
        top = (crc >> 15) & 1
        crc = ((crc << 1) & 0xFFFF) ^ (top * 0x1021)
    return crc


def xsum8(t: torch.Tensor) -> torch.Tensor:
    t = t ^ (t >> 4)
    t = t ^ (t >> 2)
    t = t ^ (t >> 1)
    return t & 1


def crc16_finish(res: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    res = res ^ v
    v = (xsum8(v & 0xB8) | (v << 1)) & 0xFF
    return (res ^ (v << 8)) & 0xFFFF


def sx1272_data_checksum(data: torch.Tensor) -> torch.Tensor:
    """Payload CRC16 over bytes [..., L] -> [...]: a Python loop over the
    static byte axis, every packet advancing together (the JAX package's
    `lax.scan`, lora_tpu/ops/codes.py:215-236)."""
    data = data.long()
    res = torch.zeros(data.shape[:-1], dtype=torch.int64, device=data.device)
    v = torch.full_like(res, 0xFF)
    for i in range(data.shape[-1]):
        crc = crc16_shift8(res)
        v = (xsum8(v & 0xB8) | (v << 1)) & 0xFF
        res = crc ^ data[..., i]
    return crc16_finish(res, v)
