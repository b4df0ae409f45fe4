"""Streaming DC blocker, a one-pole high-pass for SDR ingest (port of
lora_tpu/ops/dcblock.py).

The reference's SDR receive topology puts a DC-removal block between the
SDR source and the demodulator (examples/rx_RN2483.pth, node
"/comms/dc_removal"): zero-IF tuners park a DC spike at band centre, and a
spike larger than the signal floods the dechirped spectrum's noise estimate
until the squelch blinds the sync scan.

    m[n] = alpha * m[n-1] + (1 - alpha) * x[n]        (DC estimate)
    y[n] = x[n] - m[n]

The JAX package runs the recurrence as `lax.associative_scan`, which torch
lacks.  Here it runs blockwise: inside a block of BLOCK samples, with the
estimate entering the block as c,

    m[n] = sum_{k<=n} alpha^(n-k) b[k] + alpha^(n+1) c,   b = (1-alpha) x,

a product with a lower-triangular matrix of powers of alpha (none above 1,
so nothing overflows, unlike a cumulative sum of x * alpha^-n); the
estimates entering the blocks follow the same recurrence over the blocks'
last values with alpha^BLOCK in place of alpha, solved by the same routine.
The carried state (the last estimate) makes chunked streaming seam-free.
On the card a call runs as one captured program per alpha and layout
(utils/jit.py), lora_tpu's jitted `_dcblock` (lora_tpu/ops/dcblock.py:58).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cplx
from ..utils import jit

BLOCK = 1024


class DcState(NamedTuple):
    """Last DC estimate per stream, float32 of the input's batch shape."""

    re: torch.Tensor
    im: torch.Tensor


@functools.lru_cache(maxsize=None)
def _powers(a: float, n: int, device: torch.device) -> tuple:
    """(P [n, n] with P[i, k] = a^(i-k) for k <= i else 0, a^(i+1) [n]),
    float32 on `device`, from float64."""
    i = np.arange(n)
    d = i[:, None] - i[None, :]
    P = np.where(d >= 0, np.float64(a) ** np.maximum(d, 0), 0.0)
    q = np.float64(a) ** (i + 1)
    return (torch.from_numpy(P.astype(np.float32)).to(device),
            torch.from_numpy(q.astype(np.float32)).to(device))


def _recur(b: torch.Tensor, a: float, c: torch.Tensor) -> torch.Tensor:
    """m[n] = a*m[n-1] + b[n] along the last axis of b [..., T], m[-1] = c
    [...]; float32."""
    T = b.shape[-1]
    L = min(T, BLOCK)
    nb = -(-T // L)
    # zeros past the end change no earlier output
    blocks = torch.nn.functional.pad(b, (0, nb * L - T)).reshape(
        *b.shape[:-1], nb, L)
    P, q = _powers(a, L, b.device)
    with cplx.full_float32():
        local = torch.matmul(blocks, P.T)  # each block from a zero estimate
    if nb == 1:
        carry = c[..., None]
    else:
        # the estimate entering block j + 1 is a^L times the one entering
        # block j plus block j's own last value
        after = _recur(local[..., :-1, L - 1], a ** L, c)
        carry = torch.cat([c[..., None], after], -1)
    m = local + carry[..., None] * q
    return m.reshape(*b.shape[:-1], nb * L)[..., :T]


def dcblock(x, alpha: float = 0.999, state: Optional[DcState] = None,
            device=None) -> tuple[torch.Tensor, DcState]:
    """High-pass complex IQ x [..., T] with a one-pole DC blocker ->
    (complex64 y, state).  Pass the returned state back in to continue a
    chunked stream with no seam.  A tensor is filtered where it lies; host
    data goes to `device` (the card when None).

    alpha sets the tracking constant: the -3 dB cutoff is about
    (1-alpha)/pi of the sample rate; the 0.999 default settles in about
    1000 samples, well under one LoRa symbol at SF10 and above."""
    x, dev = cplx.stage_iq(x, device)
    if x.shape[-1] == 0:
        x = x.to(dev)
        z = x.real.new_zeros(x.shape[:-1])
        return x, state if state is not None else DcState(z, z)
    c_re, c_im = (None, None) if state is None else state
    y, m_re, m_im = _dcblock(x, float(np.float32(alpha)), c_re, c_im, dev)
    return y, DcState(m_re, m_im)


@jit.program(static=("a",), inplace=("x",))
def _dcblock(x: torch.Tensor, a: float, c_re: Optional[torch.Tensor],
             c_im: Optional[torch.Tensor], device: torch.device):
    """dcblock of complex64 x [..., T] on `device` from the estimates
    (c_re, c_im) (None: zeros), with no host sync -> (y, last estimate's
    re, im)."""
    planes = torch.view_as_real(x.to(device)).movedim(-1, 0)  # [2, ..., T]
    if c_re is None:
        c = planes.new_zeros(planes.shape[:-1])
    else:
        c = torch.stack([c_re, c_im]).to(device, torch.float32)
    b = planes * np.float32(1.0 - a)
    m = _recur(b, a, c)
    y = torch.complex(planes[0] - m[0], planes[1] - m[1])
    last = m[..., -1].clone()  # contiguous, as a replay's clone is
    return y, last[0], last[1]
