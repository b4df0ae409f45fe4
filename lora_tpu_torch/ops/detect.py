"""Plain dechirp + FFT + peak detection (port of lora_tpu/ops/detect.py).

The transform is `torch.fft.fft`, as the JAX package's CPU route uses
`jnp.fft.fft` (lora_tpu/ops/fft.py:99-108); its matmul and four-step forms
existed for the TPU's matrix unit and have no counterpart here.  This is the
plain version of kernel A (ops/cuda_detect.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import cplx
from .chirp import dechirp_table


@dataclasses.dataclass
class DetectResult:
    """Per-window detector outputs, shape [...] = the input's window axes."""

    value: torch.Tensor     # int32 argmax bin (lowest on ties)
    power: torch.Tensor     # float32 peak power, dB less 20*log10(N)
    noise: torch.Tensor     # float32 residual power, dB less 20*log10(N)
    f_index: torch.Tensor   # float32 fractional-bin offset of the peak
    mag2: Optional[torch.Tensor] = None  # float32 [..., N] |FFT|^2


def rotator(ferr, N: int, device=None) -> torch.Tensor:
    """Fine-CFO derotator exp(-2j*pi*ferr*n/N), ferr in bins, broadcasting
    over leading axes.  The angle is (c * ferr) * n in float32, c = -2*pi/N
    rounded to float32, exactly as the JAX package and the kernels form it."""
    ferr = torch.as_tensor(ferr, dtype=torch.float32, device=device)
    n = torch.arange(N, dtype=torch.float32, device=ferr.device)
    ang = (ferr * np.float32(-2 * math.pi / N))[..., None] * n
    return torch.complex(torch.cos(ang), torch.sin(ang))


def dechirp(x: torch.Tensor, down: bool = False, ferr=None) -> torch.Tensor:
    """Multiply windows [..., N] by the dechirp table, then by the fine-CFO
    derotator when ferr is given."""
    N = x.shape[-1]
    d = x * dechirp_table(N, down, x.device)
    if ferr is not None:
        d = d * rotator(ferr, N, x.device)
    return d


def _db(a: torch.Tensor, N: int) -> torch.Tensor:
    scale = np.float32(20.0 * np.log10(N))
    return 20.0 * torch.log10(torch.clamp(a, min=1e-20)) - scale


def from_mag2(mag2: torch.Tensor, want_mag2: bool = False,
              want_f_index: bool = True) -> DetectResult:
    """Reductions of |FFT|^2 windows [..., N] (lora_tpu/ops/detect.py:64-91)."""
    N = mag2.shape[-1]
    peak2 = mag2.amax(-1)
    value = torch.argmax(mag2, dim=-1).to(torch.int32)
    total = mag2.sum(-1)
    fund = torch.sqrt(peak2)
    noise_amp = torch.sqrt(torch.clamp(total - peak2, min=0.0))
    if want_f_index:
        v = value.long()[..., None]
        left = torch.sqrt(torch.gather(mag2, -1, (v - 1) % N))[..., 0]
        right = torch.sqrt(torch.gather(mag2, -1, (v + 1) % N))[..., 0]
        denom = 2.0 * fund - right - left
        f_index = torch.where(
            denom == 0.0, torch.zeros_like(denom), 0.5 * (right - left) / denom
        )
    else:
        f_index = torch.zeros_like(fund)
    return DetectResult(
        value=value,
        power=_db(fund, N),
        noise=_db(noise_amp, N),
        f_index=f_index,
        mag2=mag2 if want_mag2 else None,
    )


def detect(dechirped: torch.Tensor, want_mag2: bool = False,
           want_f_index: bool = True) -> DetectResult:
    """argmax(|FFT|^2) detection over dechirped windows [..., N]."""
    return from_mag2(cplx.mag2(torch.fft.fft(dechirped)), want_mag2,
                     want_f_index)


def dechirp_detect(x: torch.Tensor, down: bool = False, ferr=None,
                   want_mag2: bool = False,
                   want_f_index: bool = True) -> DetectResult:
    """Dechirp + detect over sample windows [..., N]."""
    return detect(dechirp(x, down, ferr), want_mag2, want_f_index)
