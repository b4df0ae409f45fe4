"""IQ samples in the port: complex64 tensors.

The JAX package keeps IQ planar (an `IQ(re, im)` pair of float32 arrays)
because its TPU runtime has no complex buffers.  The port keeps one
complex64 tensor instead, which the CUDA kernels read as interleaved
`float2`.  `as_iq` accepts either form, so a JAX `IQ` converts without
importing jax; `from_planar` / `to_planar` are the conversion between the
two packages' arrays in tests.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device) if device is not None else a
    a = np.asarray(a)
    if not a.flags.writeable:  # e.g. a jax array's host view
        a = a.copy()
    return torch.as_tensor(a, device=device)


def as_iq(x, device=None) -> torch.Tensor:
    """Coerce a complex tensor, complex numpy array, `(re, im)` pair or real
    array (imag = 0) to a complex64 tensor, on `device` when given."""
    if hasattr(x, "re") and hasattr(x, "im"):
        # the JAX package's IQ: its integer indexing slices both planes
        return from_planar(x.re, x.im, device)
    if isinstance(x, (tuple, list)) and len(x) == 2:
        re, im = x
        return from_planar(re, im, device)
    t = _tensor(x, device)
    if t.is_complex():
        return t.to(torch.complex64)
    t = t.to(torch.float32)
    return torch.complex(t, torch.zeros_like(t))


def from_planar(re, im, device=None) -> torch.Tensor:
    """Planar float32 (re, im) arrays of any framework -> complex64 tensor."""
    re = _tensor(re, device).to(torch.float32)
    im = _tensor(im, device).to(torch.float32)
    return torch.complex(re, im)


def to_planar(x: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """complex tensor -> planar float32 numpy (re, im)."""
    x = x.detach().cpu()
    return x.real.numpy().astype(np.float32), x.imag.numpy().astype(np.float32)


def from_turns(turns: torch.Tensor, ampl=1.0) -> torch.Tensor:
    """exp(2j*pi*turns) * ampl, with the angle formed in float32."""
    ang = turns.to(torch.float32) * np.float32(2 * math.pi)
    a = np.float32(ampl)
    return torch.complex(torch.cos(ang) * a, torch.sin(ang) * a)


def mag2(x: torch.Tensor) -> torch.Tensor:
    return x.real * x.real + x.imag * x.imag
