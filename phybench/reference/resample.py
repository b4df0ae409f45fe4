"""The plain fractional resampler.

A frozen copy of lora_tpu_torch/ops/resample.py (`_taps_eff`, `_plan`,
`_apply`'s gather, product and add in float32, one tap at a time in a
fixed order) and of lora_tpu_torch/ops/tables.py (`resample_bank`), in
plain torch: output m draws from input position m * ratio, planned on the
host in float64, its `taps` neighbours clamped to the input's ends and
weighed by one of NPHASE windowed-sinc subfilters.  No matrix product runs
here, so TF32 has nothing to round.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

NPHASE = 128
TAPS = 8


@functools.lru_cache(maxsize=None)
def bank(cutoff_num: int, cutoff_den: int, taps: int,
         beta: float = 8.0) -> np.ndarray:
    """float32 [NPHASE, taps]: a Kaiser-windowed sinc of NPHASE * taps
    (cutoff num/den of the input Nyquist) split into its polyphase
    components, each with unit DC gain."""
    cutoff = min(1.0, cutoff_num / cutoff_den)
    L = NPHASE * taps
    n = np.arange(L) - L / 2
    proto = np.sinc(cutoff * n / NPHASE) * np.kaiser(L, beta)
    h = np.zeros((NPHASE, taps), np.float64)
    for p in range(NPHASE):
        sub = proto[p::NPHASE][:taps]
        h[p, : sub.shape[0]] = sub / max(sub.sum(), 1e-9)
    return h.astype(np.float32)


def taps_for(ratio: float) -> int:
    if ratio <= 1:
        return TAPS
    t = int(np.ceil(TAPS * ratio))
    return t + (t % 2)


def plan(M: int, ratio: float, taps: int):
    """(idx [M, taps] int64, phase [M] int64) of outputs 0..M-1."""
    pos = np.arange(M) * ratio
    base = np.floor(pos).astype(np.int64)
    p = ((pos - base) * NPHASE).round().astype(np.int64)
    base = base + (p > 0)
    phase = (NPHASE - p) % NPHASE
    idx = base[:, None] + (np.arange(taps)[None, :] - taps // 2)
    return idx, phase


def resample(x: torch.Tensor, ratio: float, out_len: int) -> torch.Tensor:
    """complex64 [..., T] -> complex64 [..., out_len], `ratio` inputs an
    output (above 1 decimates, with the cutoff at 1/ratio)."""
    T = x.shape[-1]
    taps = taps_for(ratio)
    idx, phase = plan(out_len, ratio, taps)
    num, den = (1000, int(round(1000 * ratio))) if ratio > 1 else (1, 1)
    w = torch.from_numpy(bank(num, den, taps)[phase]).to(x.device)
    ii = torch.from_numpy(np.clip(idx, 0, T - 1)).to(x.device)
    xr = torch.view_as_real(x)
    acc = None
    for j in range(taps):
        term = xr[..., ii[:, j], :] * w[:, j, None]
        acc = term if acc is None else acc + term
    return torch.view_as_complex(acc.contiguous())
