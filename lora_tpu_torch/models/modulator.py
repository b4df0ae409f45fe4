"""Batched LoRa frame modulator: symbols -> complex baseband (port of
lora_tpu/models/modulator.py).

Frame on air: preamble upchirps | 2 sync-word upchirps | 2 downchirps |
1/4 downchirp | data upchirps | zero padding.  Per-symbol phases come from
the closed-form integer chirp (ops/chirp.py); phase continuity across
symbols is an exclusive prefix sum of the symbols' end carries mod D.  The
JAX package sums in uint32 and lets it wrap (D divides 2^32); the plain
route sums in int64 and reduces with `& (D - 1)`, kernel F in uint32.

The head depends on the config alone: its numerators and end carry are
built once per config on the host, and its IQ made from them once per
device by the plain ops, so that `modulate` reads nothing back from the
card.  On a CUDA tensor `modulate` is one launch of kernel F
(ops/cuda_modulate.py), lora_tpu's one fused program; on a CPU tensor it
runs the plain route, `modulate_plain`.
"""

from __future__ import annotations

import functools

import torch

from ..config import LoRaConfig

from ..ops import cplx, cuda_modulate
from ..ops.chirp import chirp_phase_nums


@functools.lru_cache(maxsize=None)
def _head(cfg: LoRaConfig) -> tuple[torch.Tensor, int]:
    """The head's phase numerators, int64 [head_len] on the host, and its
    end carry: segment by segment, each from the carry of the ones before."""
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
        num, end = chirp_phase_nums(s, n, N, ovs, down, device="cpu")
        segs.append((num + carry) & (D - 1))
        carry = (carry + int(end)) & (D - 1)
    return torch.cat(segs), carry


def preamble_nums(cfg: LoRaConfig, device=None):
    """Head of the frame (preamble, sync, 2.25 downchirps) as phase
    numerators int64 [head_len] on `device` (the card when None; on the
    host the cached table itself: do not write into it), and the end carry
    (an int)."""
    nums, carry = _head(cfg)
    return nums.to(cplx.resolve_device(device)), carry


@functools.lru_cache(maxsize=None)
def frame_head(cfg: LoRaConfig, device: torch.device) -> torch.Tensor:
    """The head's IQ, complex64 [head_len] on `device`, made once per device
    by the plain ops (the samples every route copies)."""
    D = cfg.N * cfg.ovs * cfg.ovs
    nums, _ = preamble_nums(cfg, device)
    return cplx.from_turns(nums.to(torch.float32) / D, cfg.ampl)


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


def _frames(route, symbols, cfg: LoRaConfig, device) -> torch.Tensor:
    syms = cplx.as_tensor(symbols, device)
    squeeze = syms.dim() == 1
    syms = torch.atleast_2d(syms)
    head = frame_head(cfg, syms.device)
    out = route(syms, head, _head(cfg)[1], cfg.N,
                cfg.ovs, cfg.padding, cfg.ampl)
    return out[0] if squeeze else out


def modulate(symbols, cfg: LoRaConfig, device=None) -> torch.Tensor:
    """symbols int [B, S] (or [S]) -> complex64 [B, T], T =
    cfg.frame_samples(S), at cfg.ovs samples per chip.  A tensor is
    modulated where it lies; host data goes to `device` (the card when
    None).  On the card this is one launch of kernel F; on the CPU the
    plain route."""
    return _frames(cuda_modulate.frame, symbols, cfg, device)


def modulate_plain(symbols, cfg: LoRaConfig, device=None) -> torch.Tensor:
    """modulate by the plain route, op by op, on any device: kernel F's
    plain version (ops/cuda_modulate.frame_plain)."""
    return _frames(cuda_modulate.frame_plain, symbols, cfg, device)
