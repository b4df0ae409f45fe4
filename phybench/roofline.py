"""Operations and bytes of the kernels the per-layer rooflines read, from
the shapes a cell drives (each input read once, each output written once;
the counts of chip_smoke.py's kernel table)."""

from __future__ import annotations

import math

from .device import bound_s, window_flops

C64 = 8  # bytes of a complex64 sample


def detect(B: int, T: int, N: int) -> float:
    """Kernel A over buffers [B, T]: seconds of its bound.  It reads every
    stride-N window of the bank once and writes three words a window."""
    W = T // N
    nbytes = B * W * N * C64 + 3 * B * W * 4
    return bound_s(nbytes, B * W * window_flops(N, False))


def channelize(S: int, T: int, K: int, L: int) -> float:
    """Kernel D over wideband blocks [S, T] into [S, K, T/K]: seconds of its
    bound.  It reads the block once (a cell's history is zeros, which the
    kernel does not read) and writes the channels once; per output sample
    an L-tap complex-by-real FIR (4 L operations) and a share of a K-point
    transform (5 log2 K)."""
    M = T // K
    nbytes = S * T * C64 + S * K * M * C64
    flops = S * K * M * (4 * L + 5 * math.log2(K))
    return bound_s(nbytes, flops)
