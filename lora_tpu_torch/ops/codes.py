"""Vectorised bit-domain codecs over int tensors (port of
lora_tpu/ops/codes.py): LUT FEC, Gray maps, whitening, the diagonal
interleaver, the header checksum and the payload CRC16.  Leading axes are
batch; the last axis is the codeword, nibble or byte stream.

The tables come from ops/tables.py through `lut`, uploaded once per device:
a captured program (utils/jit.py) may not copy host data to the card, and
its warm-up fills the cache."""

from __future__ import annotations

import functools

import torch

from . import tables

_TABLES = {
    "enc": lambda rdd: tables.ENC_LUTS[rdd],
    "dec": lambda rdd: tables.DEC_LUTS[rdd],
    "dec_all": lambda: tables.DEC_LUTS.reshape(-1),
    "whiten": lambda: tables.WHITEN_SEQ,
    "interleave": tables.interleave_gather,
    "deinterleave": tables.deinterleave_gather,
    "bin_word": tables.bin_word_gather,
    "crc16": tables.crc16_table,
    "crc_whitening": tables.crc_whitening,
}


@functools.lru_cache(maxsize=None)
def lut(name: str, device: torch.device, *args) -> torch.Tensor:
    """The table `name` of ops/tables.py (built from args) as int64 on
    `device`, uploaded at its first use there."""
    return torch.as_tensor(_TABLES[name](*args), dtype=torch.int64,
                           device=device)


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
    return lut("enc", nibbles.device, rdd)[nibbles.long()]


def fec_decode(codewords: torch.Tensor, rdd):
    """codewords int [..., n] -> (nibble, error, bad) int64.  `rdd` is an
    int or an int tensor broadcastable against codewords (the
    header-announced rate)."""
    cw = codewords.long()
    if isinstance(rdd, int):
        packed = lut("dec", cw.device, rdd)[cw]
    else:
        # a corrupt header may announce rdd 5..7: the JAX gather fills those
        # lanes with INT_MIN, which unpacks to nibble 0, no error, not bad
        flat = lut("dec_all", cw.device)
        idx = rdd.long() * 256 + cw
        inside = idx < flat.numel()
        packed = torch.where(inside, flat[torch.where(inside, idx, 0)], 0)
    return packed & 0xF, (packed >> 4) & 1, (packed >> 5) & 1


def whiten(codewords: torch.Tensor, bit_ofs: int, rdd) -> torch.Tensor:
    """XOR codewords [..., n] with the whitening stream from absolute
    position `bit_ofs`, masked to 4 + rdd bits; rdd may be a tensor."""
    n = codewords.shape[-1]
    seq = lut("whiten", codewords.device)[:, bit_ofs : bit_ofs + n]
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
    idx = lut("interleave", cw.device, ppm, rdd)  # (nbits, ppm)
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
    m_idx = lut("deinterleave", sym.device, ppm, rdd)
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


def crc16_step(res: torch.Tensor, byte: torch.Tensor) -> torch.Tensor:
    """One byte of the payload CRC: 8 steps of the 0x1021 shift register
    over res [...] (16-bit) as one step of tables.crc16_table, then the
    byte [...] in [0, 256)."""
    t = lut("crc16", res.device)
    return ((res << 8) & 0xFFFF) ^ t[(res >> 8) & 0xFF] ^ byte


def crc16_finish(res: torch.Tensor, n, L: int) -> torch.Tensor:
    """The CRC from res after n of at most L bytes (an int, or an int
    tensor of res's shape in [0, L]): res ^ V[n] ^ V[n + 1] << 8 with the
    masking register V of tables.crc_whitening."""
    v = lut("crc_whitening", res.device, L + 1)
    return (res ^ v[n] ^ (v[n + 1] << 8)) & 0xFFFF


def sx1272_data_checksum(data: torch.Tensor) -> torch.Tensor:
    """Payload CRC16 over bytes [..., L] in [0, 256) -> [...]: a Python loop
    over the static byte axis, every packet advancing together, a table
    step a byte (the JAX package's `lax.scan` of 8 register steps,
    lora_tpu/ops/codes.py:215-236, bit for bit)."""
    data = data.long()
    res = torch.zeros(data.shape[:-1], dtype=torch.int64, device=data.device)
    for i in range(data.shape[-1]):
        res = crc16_step(res, data[..., i])
    return crc16_finish(res, data.shape[-1], data.shape[-1])
