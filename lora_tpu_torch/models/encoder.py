"""Batched LoRa encoder: payload bytes -> modulation symbols (port of
lora_tpu/models/encoder.py; the same pipeline and the same deliberate
zero padding of nibbles past the payload)."""

from __future__ import annotations

import torch

from ..config import HEADER_RDD, N_HEADER_CODEWORDS, LoRaConfig

from ..ops import codes, cplx
from ..utils import jit


def _bytes_to_nibbles(data: torch.Tensor, n_nibbles: int) -> torch.Tensor:
    """bytes [..., L] -> nibble stream [..., n_nibbles], low nibble first."""
    pad = (n_nibbles + 1) // 2 - data.shape[-1]
    if pad > 0:
        data = torch.nn.functional.pad(data, (0, pad))
    nib = torch.stack([data & 0xF, (data >> 4) & 0xF], dim=-1)
    return nib.reshape(*data.shape[:-1], -1)[..., :n_nibbles]


def encode(payload, cfg: LoRaConfig, payload_len: int | None = None,
           device=None) -> torch.Tensor:
    """payload uint8/int [B, L] (or [L]) -> int32 [B, S] symbols in
    [0, 2^sf), S = cfg.num_symbols(L).  A tensor is encoded where it lies;
    host data goes to `device` (the card when None).  On the card this runs
    as one captured program per (cfg, payload_len) and payload layout
    (utils/jit.py), lora_tpu's jitted `encode`
    (lora_tpu/models/encoder.py:43)."""
    data, dev = cplx.stage(payload, device)
    if payload_len is None:
        payload_len = data.shape[-1]
    squeeze = data.dim() == 1
    symbols = _encode(torch.atleast_2d(data), cfg, payload_len, dev)
    return symbols[0] if squeeze else symbols


@jit.program(static=("cfg", "payload_len"))
def _encode(data: torch.Tensor, cfg: LoRaConfig, payload_len: int,
            device: torch.device) -> torch.Tensor:
    """encode of payload bytes [B, L] on `device`, with no host sync."""
    data = data.to(device).long()[..., :payload_len]
    ppm, rdd, sf = cfg.PPM, cfg.rdd, cfg.sf

    if cfg.crc:
        crc = codes.sx1272_data_checksum(data)
        data = torch.cat([data, (crc & 0xFF)[..., None],
                          ((crc >> 8) & 0xFF)[..., None]], dim=-1)

    ncw = cfg.num_codewords(payload_len)
    start = N_HEADER_CODEWORDS if cfg.explicit_header else 0
    nibbles = _bytes_to_nibbles(data, ncw - start)

    # first block's payload nibbles are always Hamming(8,4)
    n_first = ppm - start
    cw_first = codes.fec_encode(nibbles[..., :n_first], HEADER_RDD)
    cw_rest = codes.fec_encode(nibbles[..., n_first:], rdd)

    if cfg.whitening:
        cw_first = codes.whiten(cw_first, 0, HEADER_RDD)
        if ncw > ppm:
            cw_rest = codes.whiten(cw_rest, ppm - start, rdd)

    if cfg.explicit_header:
        lead = data.shape[:-1]
        hdr0 = torch.full(lead, payload_len, dtype=torch.int64,
                          device=data.device)
        hdr1 = torch.full_like(hdr0, (1 if cfg.crc else 0) | (rdd << 1))
        hdr2 = codes.header_checksum(hdr0, hdr1)
        hdr_cw = codes.fec_encode(
            torch.stack([hdr0 >> 4, hdr0 & 0xF, hdr1 & 0xF, hdr2 >> 4,
                         hdr2 & 0xF], dim=-1),
            HEADER_RDD,
        )
        block0 = torch.cat([hdr_cw, cw_first], dim=-1)
    else:
        block0 = cw_first

    symbols = codes.interleave(block0, ppm, HEADER_RDD)
    if ncw > ppm:
        symbols = torch.cat(
            [symbols, codes.interleave(cw_rest, ppm, rdd)], dim=-1
        )
    # Gray decode + LSB padding for reduced symbol sets.  Symbols are below
    # 2^sf; the JAX package returns them as uint16, the port as int32.
    return (codes.gray_to_binary(symbols) << (sf - ppm)).to(torch.int32)
