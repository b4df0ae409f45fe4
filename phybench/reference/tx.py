"""The frozen plain transmitter: payload bytes -> symbols -> frames.

A copy of lora_tpu_torch/models/encoder.py (`_encode`), of
lora_tpu_torch/ops/chirp.py (`chirp_phase_nums`) and of the plain route of
lora_tpu_torch/models/modulator.py with ops/cuda_modulate.py
(`_head`, `frame_plain`): kernel F is not used, so no change to the
program moves the benchmark's inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import codes
from .lora import HEADER_RDD, N_HEADER_CODEWORDS, Radio


def _bytes_to_nibbles(data: torch.Tensor, n_nibbles: int) -> torch.Tensor:
    pad = (n_nibbles + 1) // 2 - data.shape[-1]
    if pad > 0:
        data = torch.nn.functional.pad(data, (0, pad))
    nib = torch.stack([data & 0xF, (data >> 4) & 0xF], dim=-1)
    return nib.reshape(*data.shape[:-1], -1)[..., :n_nibbles]


def encode(payload: torch.Tensor, cfg: Radio) -> torch.Tensor:
    """uint8 [B, L] -> int64 symbols [B, cfg.num_symbols(L)]."""
    data = payload.long()
    L = data.shape[-1]
    ppm, rdd, sf = cfg.PPM, cfg.rdd, cfg.sf
    if cfg.crc:
        crc = codes.data_checksum(data)
        data = torch.cat([data, (crc & 0xFF)[..., None],
                          ((crc >> 8) & 0xFF)[..., None]], dim=-1)
    ncw = cfg.num_codewords(L)
    start = N_HEADER_CODEWORDS if cfg.explicit_header else 0
    nibbles = _bytes_to_nibbles(data, ncw - start)
    n_first = ppm - start
    cw_first = codes.fec_encode(nibbles[..., :n_first], HEADER_RDD)
    cw_rest = codes.fec_encode(nibbles[..., n_first:], rdd)
    if cfg.whitening:
        cw_first = codes.whiten(cw_first, 0, HEADER_RDD)
        if ncw > ppm:
            cw_rest = codes.whiten(cw_rest, ppm - start, rdd)
    if cfg.explicit_header:
        hdr0 = torch.full(data.shape[:-1], L, dtype=torch.int64,
                          device=data.device)
        hdr1 = torch.full_like(hdr0, (1 if cfg.crc else 0) | (rdd << 1))
        hdr2 = codes.header_checksum(hdr0, hdr1)
        hdr_cw = codes.fec_encode(
            torch.stack([hdr0 >> 4, hdr0 & 0xF, hdr1 & 0xF, hdr2 >> 4,
                         hdr2 & 0xF], dim=-1), HEADER_RDD)
        block0 = torch.cat([hdr_cw, cw_first], dim=-1)
    else:
        block0 = cw_first
    symbols = codes.interleave(block0, ppm, HEADER_RDD)
    if ncw > ppm:
        symbols = torch.cat([symbols, codes.interleave(cw_rest, ppm, rdd)],
                            dim=-1)
    return codes.gray_to_binary(symbols) << (sf - ppm)


def chirp_phase_nums(s: torch.Tensor, n: int, N: int, ovs: int = 1,
                     down: bool = False):
    """Integer phase numerators mod D = N*ovs^2 of chirp symbols s:
    (num int64 [..., n], end carry int64 [...])."""
    D = N * ovs * ovs
    s = s.long()[..., None]
    i1 = torch.arange(1, n + 1, dtype=torch.int64, device=s.device)
    A = s * ovs + (2 * D - N * ovs // 2) % D
    tri = ((i1 * (i1 + 1)) & (2 * D - 1)) >> 1
    w = torch.clamp(i1 + 1 - ovs * (N - s), min=0)
    num = (i1 * A + tri + w * ((D - N * ovs % D) % D)) & (D - 1)
    carry = num[..., -1]
    if down:
        num = (D - num) & (D - 1)
        carry = (D - carry) & (D - 1)
    return num, carry


def from_turns(turns: torch.Tensor, ampl: float) -> torch.Tensor:
    ang = turns.to(torch.float32) * np.float32(2 * math.pi)
    a = np.float32(ampl)
    return torch.complex(torch.cos(ang) * a, torch.sin(ang) * a)


def _head(cfg: Radio, device) -> tuple[torch.Tensor, int]:
    """The head's IQ (preamble, sync word, 2.25 downchirps) and its end
    carry, segment by segment."""
    N, ovs, NN = cfg.N, cfg.ovs, cfg.NN
    D = N * ovs * ovs
    plan = ([(0, NN, False)] * cfg.preamble_symbols
            + [((cfg.sync >> 4) * 8, NN, False),
               ((cfg.sync & 0xF) * 8, NN, False)]
            + [(0, NN, True), (0, NN, True), (0, NN // 4, True)])
    segs, carry = [], 0
    for s, n, down in plan:
        num, end = chirp_phase_nums(torch.tensor(s), n, N, ovs, down)
        segs.append((num + carry) & (D - 1))
        carry = (carry + int(end)) & (D - 1)
    nums = torch.cat(segs).to(device)
    return from_turns(nums.to(torch.float32) / D, cfg.ampl), carry


def modulate(symbols: torch.Tensor, cfg: Radio) -> torch.Tensor:
    """int [B, S] -> complex64 [B, cfg.frame_samples(S)] on their device."""
    B, S = symbols.shape
    N, ovs = cfg.N, cfg.ovs
    NN, D = N * ovs, N * ovs * ovs
    head, head_carry = _head(cfg, symbols.device)
    nums, carries = chirp_phase_nums(symbols, NN, N, ovs)
    starts = (torch.cumsum(carries, dim=-1) - carries + head_carry) & (D - 1)
    nums = (nums + starts[..., None]) & (D - 1)
    data = from_turns(nums.to(torch.float32) / D, cfg.ampl)
    return torch.cat([
        head.expand(B, -1), data.reshape(B, S * NN),
        torch.zeros((B, cfg.padding * NN), dtype=torch.complex64,
                    device=symbols.device)], dim=-1)


def frames(payload: torch.Tensor, cfg: Radio, chunk: int = 1024):
    """Payloads uint8 [B, L] -> modulated frames complex64 [B, Lf], made in
    chunks of rows (the plain route's int64 numerators are 8 bytes a
    sample)."""
    return torch.cat([modulate(encode(payload[i : i + chunk], cfg), cfg)
                      for i in range(0, payload.shape[0], chunk)])
