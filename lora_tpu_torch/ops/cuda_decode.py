"""Kernel G: a bank of LoRa frames decoded in one launch (csrc/decode.cu).

lora_tpu's `decode` (lora_tpu/models/decoder.py:104) is one jitted program,
which XLA fuses; it has no pallas_call.  Op by op, the same function
(models/decoder.decode_plain) is about 550 small launches a call, whatever
the bank: a Gray map, a deinterleave, dewhitening, FEC lookups, the header
parse and, in masked_crc16, eight elementwise kernels for every byte
position.  Kernel G is that fusion: a block stages its frames' symbols and
the lookup tables in shared memory, forms every codeword, then one thread a
frame walks the header, the FEC decode, the error mask, the bytes, the CRC
and the status.

`geometry` forms a call's static geometry, once for the whole repo, and
refuses what decode_plain cannot decode; `decode` launches the kernel on a
CUDA tensor or raises.  models/decoder.decode takes decode_plain for a
tensor that lies on the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import (HEADER_RDD, N_HEADER_CODEWORDS, N_HEADER_SYMBOLS,
                      LoRaConfig)
from . import _cuda, codes, tables

# the kernel's symbol dtypes, by its dtype code
_DTYPES = {torch.uint8: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
           torch.int64: 4}


class Geometry(NamedTuple):
    """The static geometry of a decode of S symbols a row."""

    ncw: int     # codewords a frame
    nexist: int  # codeword blocks formed from symbols; the later ones are 0
    K: int       # symbols a row that those blocks read
    M: int       # bytes a frame: the width of DecodeResult.data


@functools.lru_cache(maxsize=None)
def geometry(cfg: LoRaConfig, S: int, num_symbols: int) -> Geometry:
    """The geometry of S symbols a row decoded as num_symbols; raises
    ValueError where decode_plain cannot decode it (it would fail on a
    shape or slice a table short)."""
    ppm, rdd = cfg.PPM, cfg.rdd
    nbits = 4 + rdd
    if num_symbols < 1:
        raise ValueError(f"decode: num_symbols {num_symbols} < 1")
    nsym = -(-num_symbols // nbits) * nbits
    W = S + nsym - num_symbols  # the symbols after the zero padding
    nblocks = nsym // nbits
    ncw = nblocks * ppm
    start = N_HEADER_CODEWORDS if cfg.explicit_header else 0
    # the blocks decode_plain's deinterleave forms, whose codewords its
    # payload axis of ncw - start must match: the header block of 8
    # symbols, then blocks of nbits (or blocks of 8 throughout at 4/8)
    if rdd == HEADER_RDD:
        nexist = W // N_HEADER_SYMBOLS
        fits = nexist == nblocks
    else:
        nexist = 1 + ((W - N_HEADER_SYMBOLS) // nbits
                      if nsym > N_HEADER_SYMBOLS else 0)
        fits = W >= N_HEADER_SYMBOLS and nexist <= nblocks and ppm >= start
    if not fits:
        raise ValueError(f"decode: {S} symbols a row decoded as "
                         f"{num_symbols} do not form {ncw} codewords")
    if ncw - start > tables.WHITEN_LEN or ncw < max(start, 1):
        raise ValueError(f"decode: {ncw} codewords a frame is outside "
                         f"[{max(start, 1)}, {tables.WHITEN_LEN + start}]")
    K = min(S, N_HEADER_SYMBOLS + (nexist - 1) * nbits)
    return Geometry(ncw, nexist, K, (ncw + 1) // 2)


def decode(sym: torch.Tensor, cfg: LoRaConfig, num_symbols: int):
    """Kernel G on CUDA symbols [..., S] of at least two axes, read in their
    own dtype and strides -> (data uint8 [..., M], ints int32 [7, ...]:
    offset, length, status, packet_length, rdd, fec_errors, bad,
    crc_present bool [...]), the fields of DecodeResult; with
    cfg.interleaving=False the Gray-mapped symbols, int32 [..., S].
    Raises where it cannot launch."""
    if not sym.is_cuda:
        raise ValueError(f"decode: kernel G runs on a CUDA tensor, not on "
                         f"{sym.device}")
    if sym.dtype not in _DTYPES:
        raise TypeError(f"decode: expected integer symbols, got {sym.dtype}")
    if sym.dim() < 2:
        raise ValueError(f"decode: expected symbols [..., S], got "
                         f"{tuple(sym.shape)}")
    if not -(1 << 30) < cfg.data_length < 1 << 30:
        raise ValueError(f"decode: data_length {cfg.data_length} outside "
                         "the kernel's int32 range")
    *lead, S = sym.shape
    x = sym.reshape(-1, S)  # a view of the symbols [B, S] the callers pass
    B = x.shape[0]
    dev = sym.device
    lib = _cuda.library()
    head = (x.data_ptr(), _DTYPES[sym.dtype], B, S, x.stride(0), x.stride(1),
            cfg.sf, cfg.PPM, cfg.rdd, int(cfg.explicit_header), int(cfg.hdr),
            int(cfg.crc_check), int(cfg.error_check), int(cfg.interleaving),
            cfg.data_length)
    if not cfg.interleaving:
        out = torch.empty((*lead, S), dtype=torch.int32, device=dev)
        if B and S:
            err = lib.lora_decode(*head, 0, 0, 0, None, None, 0, None, None,
                                  out.data_ptr(), None, None,
                                  _cuda.stream(dev))
            _cuda.check(err, "lora_decode")
        return out
    g = geometry(cfg, S, num_symbols)
    data = torch.empty((*lead, g.M), dtype=torch.uint8, device=dev)
    ints = torch.empty((7, *lead), dtype=torch.int32, device=dev)
    crc_present = torch.empty(lead, dtype=torch.bool, device=dev)
    if B:
        whiten = codes.lut("whiten", dev)
        err = lib.lora_decode(
            *head, g.ncw, g.nexist, g.K, codes.lut("dec_all", dev).data_ptr(),
            whiten.data_ptr(), whiten.shape[1],
            codes.lut("crc16", dev).data_ptr(),
            codes.lut("crc_whitening", dev, g.M + 1).data_ptr(),
            data.data_ptr(), ints.data_ptr(), crc_present.data_ptr(),
            _cuda.stream(dev))
        _cuda.check(err, "lora_decode")
    return data, ints, crc_present
