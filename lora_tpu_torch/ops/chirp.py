"""Closed-form chirp phase (port of lora_tpu/ops/chirp.py).

The phase at sample i of a symbol s is an exact integer numerator mod
D = N*ovs^2 (lora_tpu/ops/chirp.py:38-74).  The JAX package computes it in
uint32 and lets the products wrap mod 2^32, which D divides.  torch's uint32
support is partial, so the port computes in int64 and reduces with
`& (D - 1)`: the same residues, with no wrap needed.
"""

from __future__ import annotations

import functools

import torch

from . import cplx
from .tables import dechirp_table_np


def chirp_phase_nums(s, n_samples: int, N: int, ovs: int = 1,
                     down: bool = False, device=None):
    """Integer phase numerators of chirp symbols s (any int shape):
    returns (num int64 [..., n_samples] in [0, D), carry int64 [...])."""
    D = N * ovs * ovs
    if D & (D - 1):
        raise ValueError("oversampling ratio must be a power of two")
    if D * 2 > 1 << 31:
        raise ValueError("N*ovs^2 too large for exact int32 phase arithmetic")
    s = torch.as_tensor(s, dtype=torch.int64, device=device)[..., None]
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


@functools.lru_cache(maxsize=None)
def dechirp_table(N: int, down: bool = False, device="cpu") -> torch.Tensor:
    """Unit dechirp multiplier complex64 [N]; down=False flattens up-chirps."""
    re, im = dechirp_table_np(N, down)
    return cplx.from_planar(re, im, torch.device(device))
