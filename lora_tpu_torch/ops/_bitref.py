"""Scalar bit-domain reference implementations of the SX1272 LoRa codecs.

These pure-Python functions define the bit-level contracts of the LoRa PHY
(Gray mapping, Hamming/parity FEC, whitening, diagonal interleaving, header
checksum, payload CRC16).  `ops/tables.py` builds the lookup tables of the
vectorised codecs (`ops/codes.py`) from them, and the tests use them as a
slow but obvious oracle.

This is the port's own copy of `lora_tpu/ops/_bitref.py` (the port imports
nothing of the JAX package); `tests/test_torch_config.py` holds the two
files' functions against each other.  The behaviour follows the reference
implementation's LoRaCodes.hpp: Gray maps (179-194), Hamming(8,4) SEC-DED
(201-253), Hamming(7,4) SEC (259-306), parity(5,4)/(6,4) (312-343),
whitening LFSRs (128-167), diagonal interleaver (348-378), header checksum
(31-55), payload CRC16 (57-93).
"""

from __future__ import annotations

HEADER_RDD = 4
N_HEADER_SYMBOLS = HEADER_RDD + 4
N_HEADER_CODEWORDS = 5


def round_up(num: int, factor: int) -> int:
    return ((num + factor - 1) // factor) * factor


# ---------------------------------------------------------------------------
# Gray mapping
# ---------------------------------------------------------------------------

def binary_to_gray16(num: int) -> int:
    return (num ^ (num >> 1)) & 0xFFFF


def gray_to_binary16(num: int) -> int:
    num ^= num >> 8
    num ^= num >> 4
    num ^= num >> 2
    num ^= num >> 1
    return num & 0xFFFF


# ---------------------------------------------------------------------------
# Hamming / parity FEC (SX1272 bit order)
# ---------------------------------------------------------------------------

def _bit(x: int, i: int) -> int:
    return (x >> i) & 1


def encode_hamming84(x: int) -> int:
    d0, d1, d2, d3 = (_bit(x, i) for i in range(4))
    b = x & 0xF
    b |= (d0 ^ d1 ^ d2) << 4
    b |= (d1 ^ d2 ^ d3) << 5
    b |= (d0 ^ d1 ^ d3) << 6
    b |= (d0 ^ d2 ^ d3) << 7
    return b


def decode_hamming84(b: int) -> tuple[int, bool, bool]:
    """Returns (nibble, error, bad)."""
    bits = [(b >> i) & 1 for i in range(8)]
    p0 = bits[0] ^ bits[1] ^ bits[2] ^ bits[4]
    p1 = bits[1] ^ bits[2] ^ bits[3] ^ bits[5]
    p2 = bits[0] ^ bits[1] ^ bits[3] ^ bits[6]
    p3 = bits[0] ^ bits[2] ^ bits[3] ^ bits[7]
    parity = (p0 << 0) | (p1 << 1) | (p2 << 2) | (p3 << 3)
    error = parity != 0
    if parity == 0xD:
        return (b ^ 1) & 0xF, error, False
    if parity == 0x7:
        return (b ^ 2) & 0xF, error, False
    if parity == 0xB:
        return (b ^ 4) & 0xF, error, False
    if parity == 0xE:
        return (b ^ 8) & 0xF, error, False
    if parity in (0x0, 0x1, 0x2, 0x4, 0x8):
        return b & 0xF, error, False
    return b & 0xF, error, True


def encode_hamming74(x: int) -> int:
    d0, d1, d2, d3 = (_bit(x, i) for i in range(4))
    b = x & 0xF
    b |= (d0 ^ d1 ^ d2) << 4
    b |= (d1 ^ d2 ^ d3) << 5
    b |= (d0 ^ d1 ^ d3) << 6
    return b


def decode_hamming74(b: int) -> tuple[int, bool]:
    bits = [(b >> i) & 1 for i in range(7)]
    p0 = bits[0] ^ bits[1] ^ bits[2] ^ bits[4]
    p1 = bits[1] ^ bits[2] ^ bits[3] ^ bits[5]
    p2 = bits[0] ^ bits[1] ^ bits[3] ^ bits[6]
    parity = (p0 << 0) | (p1 << 1) | (p2 << 2)
    error = parity != 0
    if parity == 0x5:
        return (b ^ 1) & 0xF, error
    if parity == 0x7:
        return (b ^ 2) & 0xF, error
    if parity == 0x3:
        return (b ^ 4) & 0xF, error
    if parity == 0x6:
        return (b ^ 8) & 0xF, error
    return b & 0xF, error


def encode_parity54(b: int) -> int:
    x = b ^ (b >> 2)
    x = x ^ (x >> 1)
    return (b & 0xF) | ((x << 4) & 0x10)


def check_parity54(b: int) -> tuple[int, bool]:
    x = b ^ (b >> 2)
    x = x ^ (x >> 1) ^ (b >> 4)
    return b & 0xF, bool(x & 1)


def encode_parity64(b: int) -> int:
    x = b ^ (b >> 1) ^ (b >> 2)
    y = x ^ b ^ (b >> 3)
    return ((x & 1) << 4) | ((y & 1) << 5) | (b & 0xF)


def check_parity64(b: int) -> tuple[int, bool]:
    x = b ^ (b >> 1) ^ (b >> 2)
    y = x ^ b ^ (b >> 3)
    x ^= b >> 4
    y ^= b >> 5
    return b & 0xF, bool((x | y) & 1)


# ---------------------------------------------------------------------------
# Whitening (dual interleaved byte LFSRs, poly 0x1D)
# ---------------------------------------------------------------------------

_LFSR_SEEDS = {
    # mode "normal" (RDD in {0, 2, 3, 4}) and mode "parity54" (RDD == 1):
    # two interleaved 64-bit registers each.
    "normal": (0x6572D100E85C2EFF, 0xE85C2EFFFFFFFFFF),
    "rdd1": (0x05121100F8ECFEEF, 0xF8ECFEEFEFEFEFEF),
}

_MASK64 = (1 << 64) - 1


def _lfsr_step(r: int) -> int:
    # byte-wide LFSR step, polynomial 0x1D over bytes:
    # shift right one byte, feed back xor of bytes 0, 2, 3, 4 into the top.
    fb = ((r >> 32) ^ (r >> 24) ^ (r >> 16) ^ r) & _MASK64
    return ((r >> 8) | (fb << 56)) & _MASK64


def whitening_sequence(length: int, rdd1_mode: bool) -> list[int]:
    """Whitening byte stream; element ``i`` whitens the codeword at absolute
    stream position ``bitOfs + j == i``.  Caller masks to ``(1 << (4+RDD)) - 1``.
    """
    seeds = _LFSR_SEEDS["rdd1" if rdd1_mode else "normal"]
    r = [seeds[0], seeds[1]]
    out = []
    for i in range(length):
        out.append(r[i & 1] & 0xFF)
        r[i & 1] = _lfsr_step(r[i & 1])
    return out


def whiten(buffer: list[int], bit_ofs: int, rdd: int) -> list[int]:
    seq = whitening_sequence(bit_ofs + len(buffer), rdd == 1)
    mask = (1 << (4 + rdd)) - 1
    return [(b ^ (seq[bit_ofs + j] & mask)) & 0xFF for j, b in enumerate(buffer)]


# ---------------------------------------------------------------------------
# Diagonal interleaver
# ---------------------------------------------------------------------------

def diagonal_interleave(codewords: list[int], ppm: int, rdd: int) -> list[int]:
    """codewords -> symbols, whole blocks of PPM codewords each."""
    nbits = 4 + rdd
    num_blocks = len(codewords) // ppm
    symbols = [0] * (num_blocks * nbits)
    for x in range(num_blocks):
        cw_off = x * ppm
        sym_off = x * nbits
        for k in range(nbits):
            for m in range(ppm):
                i = (m + k) % ppm
                bit = (codewords[cw_off + i] >> k) & 1
                symbols[sym_off + k] |= bit << m
    return symbols


def diagonal_deinterleave(symbols: list[int], ppm: int, rdd: int) -> list[int]:
    nbits = 4 + rdd
    num_blocks = len(symbols) // nbits
    codewords = [0] * (num_blocks * ppm)
    for x in range(num_blocks):
        cw_off = x * ppm
        sym_off = x * nbits
        for k in range(nbits):
            for m in range(ppm):
                i = (m + k) % ppm
                bit = (symbols[sym_off + k] >> m) & 1
                codewords[cw_off + i] |= bit << k
    return codewords


# ---------------------------------------------------------------------------
# Header checksum and payload CRC16
# ---------------------------------------------------------------------------

def header_checksum(h0: int, h1: int) -> int:
    a = [(h0 >> (4 + i)) & 1 for i in range(4)]
    b = [(h0 >> i) & 1 for i in range(4)]
    c = [(h1 >> i) & 1 for i in range(4)]
    res = (a[0] ^ a[1] ^ a[2] ^ a[3]) << 4
    res |= (a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3
    res |= (a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2
    res |= (a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1
    res |= a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3]
    return res


def _crc16_shift8(crc: int, poly: int = 0x1021) -> int:
    for _ in range(8):
        if crc & 0x8000:
            crc = ((crc << 1) ^ poly) & 0xFFFF
        else:
            crc = (crc << 1) & 0xFFFF
    return crc


def _xsum8(t: int) -> int:
    t ^= t >> 4
    t ^= t >> 2
    t ^= t >> 1
    return t & 1


def sx1272_data_checksum(data: list[int]) -> int:
    """CCITT-0x1021-variant CRC16 with 8-bit LFSR output masking."""
    res = 0
    v = 0xFF
    for byte in data:
        crc = _crc16_shift8(res)
        v = (_xsum8(v & 0xB8) | (v << 1)) & 0xFF
        res = (crc ^ byte) & 0xFFFF
    res ^= v
    v = (_xsum8(v & 0xB8) | (v << 1)) & 0xFF
    res ^= v << 8
    return res & 0xFFFF
