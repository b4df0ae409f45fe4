"""Channel impairments for loopback tests and simulation (port of
lora_tpu/sim/channel.py): AWGN, static phase, CFO, a sample delay and
sample-clock drift, on complex64 tensors.  Noise comes from a
`torch.Generator`; it cannot give jax.random's numbers, so parity tests
hand both packages the same numpy noise instead."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import resample


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


def clock_drift(x: torch.Tensor, ppm: float) -> torch.Tensor:
    """Sample-clock frequency offset between TX and RX: resample by
    (1 + ppm*1e-6) through the polyphase fractional resampler, so each
    received sample lands ppm*1e-6 later (in TX time) than the last, then
    zero-pad back to the input's length.  The demodulator's preamble
    retiming absorbs the drift accumulated over a frame up to about one
    sample."""
    T = x.shape[-1]
    y = resample.resample(x, 1.0 + ppm * 1e-6)
    return torch.nn.functional.pad(y, (0, T - y.shape[-1]))
