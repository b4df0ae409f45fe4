"""Channel impairments for loopback tests and simulation (port of
lora_tpu/sim/channel.py): AWGN, static phase, CFO and a sample delay, on
complex64 tensors.  Noise comes from a `torch.Generator`; it cannot give
jax.random's numbers, so parity tests hand both packages the same numpy
noise instead."""

from __future__ import annotations

import math

import numpy as np
import torch


def awgn(x: torch.Tensor, amplitude: float, generator: torch.Generator
         ) -> torch.Tensor:
    """x + amplitude * (n_re + 1j*n_im), unit-variance normal per leg (the
    Pothos noise source's NORMAL convention).  The generator's device must
    be x's device."""
    re = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                     device=x.device)
    im = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                     device=x.device)
    return x + amplitude * torch.complex(re, im)


def rotate(x: torch.Tensor, phase: float) -> torch.Tensor:
    """Static phase rotation by `phase` radians."""
    p = np.float32(phase)
    r = torch.complex(torch.tensor(np.cos(p)), torch.tensor(np.sin(p)))
    return x * r.to(x.device)


def cfo(x: torch.Tensor, offset_bins: float, N: int) -> torch.Tensor:
    """Carrier offset of `offset_bins` FFT bins: x * exp(2j*pi*offset*n/N)."""
    n = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    ang = np.float32(2 * math.pi / N) * np.float32(offset_bins) * n
    return x * torch.complex(torch.cos(ang), torch.sin(ang))


def time_offset(x: torch.Tensor, samples: int) -> torch.Tensor:
    """Delay by prepending `samples` zeros; the length grows by `samples`."""
    return torch.nn.functional.pad(x, (samples, 0))
