"""Batched LoRa frame modulator: symbols -> complex baseband (port of
lora_tpu/models/modulator.py).

Frame on air: preamble upchirps | 2 sync-word upchirps | 2 downchirps |
1/4 downchirp | data upchirps | zero padding.  Per-symbol phases come from
the closed-form integer chirp (ops/chirp.py); phase continuity across
symbols is an exclusive prefix sum of the symbols' end carries mod D.  The
JAX package sums in uint32 and lets it wrap (D divides 2^32); the port sums
in int64 and reduces with `& (D - 1)`.
"""

from __future__ import annotations

import torch

from ..config import LoRaConfig

from ..ops import cplx
from ..ops.chirp import chirp_phase_nums


def preamble_nums(cfg: LoRaConfig, device=None):
    """Head of the frame (preamble, sync, 2.25 downchirps) as phase
    numerators int64 [head_len] and the end carry."""
    N, ovs, NN = cfg.N, cfg.ovs, cfg.NN
    D = N * ovs * ovs
    plan = (
        [(0, NN, False)] * cfg.preamble_symbols
        + [((cfg.sync >> 4) * 8, NN, False), ((cfg.sync & 0xF) * 8, NN, False)]
        + [(0, NN, True), (0, NN, True), (0, NN // 4, True)]
    )
    segs = []
    carry = 0
    for s, n, down in plan:
        num, end = chirp_phase_nums(s, n, N, ovs, down, device=device)
        segs.append((num + carry) & (D - 1))
        carry = (carry + int(end)) & (D - 1)
    return torch.cat(segs), carry


def tx_frame_events(cfg: LoRaConfig, num_symbols: int) -> dict:
    """Sample offsets of a frame's parts in a `modulate` output row (static
    per config and symbol count; lora_tpu/models/modulator.py:51-70), for
    aligning captures with emitted frames."""
    NN = cfg.NN
    t_sync = cfg.preamble_symbols * NN
    t_down = t_sync + 2 * NN
    t_data = t_down + 2 * NN + NN // 4
    t_end = t_data + num_symbols * NN
    return {
        "t_preamble": 0,
        "t_sync": t_sync,
        "t_downchirps": t_down,
        "t_data": t_data,
        "tx_end": t_end,
        "t_pad_end": t_end + cfg.padding * NN,
    }


def modulate(symbols, cfg: LoRaConfig, device=None) -> torch.Tensor:
    """symbols int [B, S] (or [S]) -> complex64 [B, T], T =
    cfg.frame_samples(S), at cfg.ovs samples per chip.  A tensor is
    modulated where it lies; host data goes to `device` (the card when
    None)."""
    syms = cplx.as_tensor(symbols, device)
    squeeze = syms.dim() == 1
    syms = torch.atleast_2d(syms).long()
    dev = syms.device
    B, S = syms.shape
    N, ovs, NN = cfg.N, cfg.ovs, cfg.NN
    D = N * ovs * ovs

    head_nums, head_carry = preamble_nums(cfg, dev)
    head = cplx.from_turns(head_nums.to(torch.float32) / D, cfg.ampl)

    nums, carries = chirp_phase_nums(syms, NN, N, ovs, False)  # [B,S,NN], [B,S]
    starts = (torch.cumsum(carries, dim=-1) - carries + head_carry) & (D - 1)
    nums = (nums + starts[..., None]) & (D - 1)
    data = cplx.from_turns(nums.to(torch.float32) / D, cfg.ampl)

    out = torch.cat([
        head.expand(B, -1),
        data.reshape(B, S * NN),
        torch.zeros((B, cfg.padding * NN), dtype=torch.complex64, device=dev),
    ], dim=-1)
    return out[0] if squeeze else out
