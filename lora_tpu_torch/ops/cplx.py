"""IQ samples in the port: complex64 tensors.

The JAX package keeps IQ planar (an `IQ(re, im)` pair of float32 arrays)
because its TPU runtime has no complex buffers.  The port keeps one
complex64 tensor instead, which the CUDA kernels read as interleaved
`float2`.  `as_iq` accepts either form, so a JAX `IQ` converts without
importing jax; `from_planar` / `to_planar` are the conversion between the
two packages' arrays in tests.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device host data goes to: `device`, or the card when the caller
    names none.  Never the CPU by itself: without a card the default raises
    where the data is moved."""
    return torch.device("cuda" if device is None else device)


def as_tensor(a, device=None, dtype=None) -> torch.Tensor:
    """The one coercion of every entry point that accepts host data.  A
    tensor stays on the device its caller put it on (and moves only to a
    `device` given by name); host data (numpy, list, scalar, another
    framework's array) goes to resolve_device(device)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    a = np.asarray(a)
    if not a.flags.writeable:  # e.g. a jax array's host view
        a = a.copy()
    return torch.as_tensor(a, dtype=dtype, device=resolve_device(device))


def as_iq(x, device=None) -> torch.Tensor:
    """Coerce a complex tensor, complex numpy array, `(re, im)` pair or real
    array (imag = 0) to a complex64 tensor: a tensor where it lies, host
    data on `device` (the card when None; see as_tensor)."""
    if hasattr(x, "re") and hasattr(x, "im"):
        # the JAX package's IQ: its integer indexing slices both planes
        return from_planar(x.re, x.im, device)
    if isinstance(x, (tuple, list)) and len(x) == 2:
        re, im = x
        return from_planar(re, im, device)
    t = as_tensor(x, device)
    if t.is_complex():
        return t.to(torch.complex64)
    t = t.to(torch.float32)
    return torch.complex(t, torch.zeros_like(t))


def _target(x, device) -> torch.device:
    if isinstance(x, torch.Tensor) and device is None:
        return x.device
    return resolve_device(device)


def stage(a, device=None, dtype=None) -> tuple[torch.Tensor, torch.device]:
    """as_tensor for an entry point that runs as a captured program
    (utils/jit.py): a tensor stays where it lies and host data becomes a
    tensor on the host, which the program copies into a buffer of its own
    on the card.  -> (tensor, the device the call runs on: `device`, else
    the tensor's, else the card)."""
    t = as_tensor(a, None if isinstance(a, torch.Tensor) else "cpu", dtype)
    return t, _target(a, device)


def stage_iq(x, device=None) -> tuple[torch.Tensor, torch.device]:
    """as_iq as `stage` does as_tensor: -> (complex64 tensor where it lies,
    or on the host for host data; the device the call runs on)."""
    t = as_iq(x, None if isinstance(x, torch.Tensor) else "cpu")
    return t, _target(x, device)


def from_planar(re, im, device=None) -> torch.Tensor:
    """Planar float32 (re, im) arrays of any framework -> complex64 tensor."""
    re = as_tensor(re, device, torch.float32)
    im = as_tensor(im, device, torch.float32)
    return torch.complex(re, im)


def host(a) -> np.ndarray:
    """A tensor's values (wherever it lies) or an array's, as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


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


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Complex x with re and im each rounded to bfloat16 (nearest even) and
    back to float32: the operands of lora_tpu's bf16 contractions
    (lora_tpu/ops/cplx.py:114-134), whose products are exact in float32."""
    r = lambda t: t.to(torch.bfloat16).to(torch.float32)
    return torch.complex(r(x.real), r(x.imag))


@contextlib.contextmanager
def full_float32():
    """Full float32 matrix products, no TF32: the counterpart of
    cplx.matmul(precision=HIGHEST) in the JAX package."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
