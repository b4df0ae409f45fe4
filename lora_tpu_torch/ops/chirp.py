"""Closed-form chirp phase (port of lora_tpu/ops/chirp.py).

The phase at sample i of a symbol s is an exact integer numerator mod
D = N*ovs^2 (lora_tpu/ops/chirp.py:38-74).  The JAX package computes it in
uint32 and lets the products wrap mod 2^32, which D divides.  torch's uint32
support is partial, so the port computes in int64 and reduces with
`& (D - 1)`: the same residues, with no wrap needed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cplx
from .tables import dechirp_table_np


def chirp_phase_nums(s, n_samples: int, N: int, ovs: int = 1,
                     down: bool = False, device=None):
    """Integer phase numerators of chirp symbols s (any int shape):
    returns (num int64 [..., n_samples] in [0, D), carry int64 [...]).  A
    tensor is used where it lies; host data goes to `device` (the card when
    None, as in every entry point: ops/cplx.as_tensor)."""
    D = N * ovs * ovs
    if D & (D - 1):
        raise ValueError("oversampling ratio must be a power of two")
    if D * 2 > 1 << 31:
        raise ValueError("N*ovs^2 too large for exact int32 phase arithmetic")
    s = cplx.as_tensor(s, device, torch.int64)[..., None]
    i1 = torch.arange(1, n_samples + 1, dtype=torch.int64, device=s.device)
    A = s * ovs + (2 * D - N * ovs // 2) % D
    tri = ((i1 * (i1 + 1)) & (2 * D - 1)) >> 1
    w = torch.clamp(i1 + 1 - ovs * (N - s), min=0)
    wrap_term = w * ((D - N * ovs % D) % D)
    num = (i1 * A + tri + wrap_term) & (D - 1)
    carry = num[..., -1]
    if down:
        num = (D - num) & (D - 1)
        carry = (D - carry) & (D - 1)
    return num, carry


def chirp_phase_turns(s, n_samples: int, N: int, ovs: int = 1,
                      down: bool = False, device=None):
    """Phase in turns (mod 1) of chirp symbols s: (turns float32
    [..., n_samples], end carry numerator int32 [...]).  D is a power of
    two, so num / D is exact in float32."""
    D = N * ovs * ovs
    num, carry = chirp_phase_nums(s, n_samples, N, ovs, down, device)
    return num.to(torch.float32) / np.float32(D), carry.to(torch.int32)


def gen_chirp(s, N: int, ovs: int = 1, n_samples: int | None = None,
              down: bool = False, ampl: float = 1.0, phase0_turns=0.0,
              device=None):
    """Chirp symbols s as complex64 [..., n_samples] (NN by default),
    starting at phase0_turns (turns; a scalar or one per symbol), and the
    end phase in turns mod 1, for phase continuity across symbols
    (lora_tpu/ops/chirp.py:86-109)."""
    if n_samples is None:
        n_samples = N * ovs
    turns, carry = chirp_phase_turns(s, n_samples, N, ovs, down, device)
    D = N * ovs * ovs
    phase0 = cplx.as_tensor(phase0_turns, turns.device, torch.float32)
    iq = cplx.from_turns(turns + phase0[..., None], ampl)
    end = torch.remainder(phase0 + carry.to(torch.float32) / np.float32(D),
                          1.0)
    return iq, end


@functools.lru_cache(maxsize=None)
def dechirp_table(N: int, down: bool = False, device=None) -> torch.Tensor:
    """Unit dechirp multiplier complex64 [N] on `device` (the card when
    None); down=False flattens up-chirps."""
    re, im = dechirp_table_np(N, down)
    return cplx.from_planar(re, im, device)
