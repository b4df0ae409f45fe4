"""The cells' inputs, made on the card from the run's seed through the
frozen plain transmitter (phybench/reference/tx.py), in a few large calls.

`impair` and `awgn` are a copy of chip_smoke.py's (`impair`, `awgn`), with
the integer CFO's range a parameter; `bank` and `wideband` follow
chip_smoke.py's `make_bank` and `make_wideband`.
Every draw comes from one torch.Generator on the card, in a fixed order,
so the same seed gives the same inputs and every seed the same sizes.
"""

from __future__ import annotations

import torch

from .reference import channelizer as rch
from .reference import tx
from .reference.lora import Radio, required_samples

TWO_PI = 6.2831855
ROWS = 1024  # rows a call of the transmitter makes at once


def generator(seed: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(int(seed))


def impair(frames, T: int, N: int, g, max_delay: int, cfo_int: int,
           u_max: float):
    """Frames [B, Lf] placed in buffers of T samples at a random delay in
    [0, max_delay), with a CFO of k + u bins (|k| <= cfo_int, |u| < u_max)
    and a random phase."""
    B, Lf = frames.shape
    dev = frames.device
    delay = torch.randint(0, max_delay, (B, 1), generator=g, device=dev)
    src = torch.arange(T, device=dev) - delay
    valid = (src >= 0) & (src < Lf)
    out = torch.take_along_dim(frames, src.clamp(0, Lf - 1), dim=1)
    out = torch.where(valid, out, 0)
    del src, valid
    cfo = (torch.randint(-cfo_int, cfo_int + 1, (B, 1), generator=g,
                         device=dev)
           + (torch.rand((B, 1), generator=g, device=dev) * 2 - 1) * u_max)
    phase = torch.rand((B, 1), generator=g, device=dev) * TWO_PI
    n = torch.arange(T, device=dev, dtype=torch.float32)
    ang = cfo * (TWO_PI / N) * n + phase
    return out * torch.polar(torch.ones_like(ang), ang)


def awgn(shape, sigma: float, g, dev):
    return sigma * torch.complex(
        torch.randn(shape, generator=g, device=dev),
        torch.randn(shape, generator=g, device=dev))


def payloads(n: int, nbytes: int, g, dev) -> torch.Tensor:
    return torch.randint(0, 256, (n, nbytes), generator=g, device=dev,
                         dtype=torch.int64).to(torch.uint8)


def bank(cfg: Radio, B: int, nbytes: int, imp: dict, g, dev):
    """B channel buffers of required_samples(cfg), a frame each (delay in
    [0, max_delay_symbols N), CFO, phase) plus AWGN.  -> (bank complex64
    [B, T] on the card, payloads uint8 [B, nbytes] on the host)."""
    T = required_samples(cfg)
    payload = payloads(B, nbytes, g, dev)
    out = torch.empty((B, T), dtype=torch.complex64, device=dev)
    for i in range(0, B, ROWS):
        x = impair(tx.frames(payload[i : i + ROWS], cfg), T, cfg.N, g,
                   imp["max_delay_symbols"] * cfg.N, imp["cfo_int"],
                   imp["cfo_frac"])
        out[i : i + ROWS] = x + awgn(x.shape, imp["sigma"], g, dev)
        del x
    return out, payload.cpu().numpy()


def wideband(cfg: Radio, S: int, K: int, taps: int, nbytes: int,
             imp: dict, g, dev):
    """S wideband streams at rate K*BW, a frame on every one of their K
    adjacent channels (impaired as `bank`), merged by the synthesis bank,
    plus AWGN at the wideband rate.  -> (wide complex64 [S, M*K] on the
    card, payloads uint8 [S, K, nbytes] on the host)."""
    M = required_samples(cfg)
    payload = payloads(S * K, nbytes, g, dev)
    out = torch.empty((S, M * K), dtype=torch.complex64, device=dev)
    step = max(1, ROWS // K)
    for s in range(0, S, step):
        n = min(step, S - s)
        f = impair(tx.frames(payload[s * K : (s + n) * K], cfg), M,
                   cfg.N, g, imp["max_delay_symbols"] * cfg.N,
                   imp["cfo_int"], imp["cfo_frac"])
        w = rch.synthesize(f.reshape(n, K, M), taps)
        del f
        out[s : s + n] = w + awgn(w.shape, imp["sigma"], g, dev)
        del w
    return out, payload.reshape(S, K, nbytes).cpu().numpy()
