"""Kernel R: the fractional resampler's weighted sums in one pass
(csrc/resample.cu).

lora_tpu's `resample` (lora_tpu/ops/resample.py `_apply`) is one jitted
gather and sum, which XLA fuses; it has no pallas_call.  Op by op, the same
sum (ops/resample.py `_apply`, the plain route) gathers the whole input
once a tap and writes a product and a partial sum as large as the output
for each of its taps: at 8,192 rows of 65,536 samples decimated by 8/5
(14 taps) over 200 GB a call.  Kernel R reads each input sample once a
tile of outputs and writes each output once, in the plain route's float32
order, so the two agree bit for bit.

`resample` launches it on a CUDA tensor or raises; ops/resample.py takes
the plain route for a tensor that lies on the CPU.
"""

from __future__ import annotations

import math

import torch

from . import _cuda

TILE = 1024           # outputs a block, at most
SMEM_TILE = 64 << 10  # shared memory a tile may take before it is halved
SMEM_MAX = 227 << 10  # the most a block can opt in to


def smem(tile: int, span: int) -> int:
    """Bytes of a block's shared memory (csrc/resample.cu): the tile's plan
    and its span."""
    return tile * 8 + span * 8


def geometry(ratio: float, taps: int) -> tuple[int, int]:
    """(tile, span): outputs a block and the input samples a tile spans at
    most.  Outputs m and m + d of a plan start at most floor(d * ratio) + 2
    inputs apart (each rounds its position down and may move up one); two
    samples more cover the host's float64 rounding."""
    tile = TILE
    while True:
        span = math.floor((tile - 1) * ratio) + taps + 4
        if smem(tile, span) <= SMEM_TILE or tile == 1:
            break
        tile //= 2
    if smem(tile, span) > SMEM_MAX:
        raise ValueError(f"resample: a tile at the ratio {ratio} and {taps} "
                         f"taps needs {smem(tile, span)} bytes of shared "
                         "memory")
    return tile, span


def resample(x: torch.Tensor, table: torch.Tensor, weights: torch.Tensor,
             ratio: float) -> torch.Tensor:
    """Kernel R wrapper: complex64 [..., T] on the card (any strides) at
    the plan `table` (int32 [2, M] on the same card: each output's first
    input, its taps clamped to [0, T - 1], and its subfilter), weighed by
    `weights` (float32 [NPHASE, taps]) -> complex64 [..., M], contiguous."""
    if not x.is_cuda:
        raise ValueError(f"resample: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.complex64:
        raise TypeError(f"resample: expected complex64, got {x.dtype}")
    if (table.device != x.device or table.dtype != torch.int32
            or table.dim() != 2 or table.shape[0] != 2
            or not table.is_contiguous()):
        raise ValueError("resample: the plan must be a contiguous int32 "
                         "[2, M] tensor on the input's device")
    if (weights.device != x.device or weights.dtype != torch.float32
            or weights.dim() != 2 or not weights.is_contiguous()):
        raise ValueError("resample: the bank must be a contiguous float32 "
                         "[NPHASE, taps] tensor on the input's device")
    T, M, taps = x.shape[-1], table.shape[1], weights.shape[1]
    out = torch.empty(x.shape[:-1] + (M,), dtype=torch.complex64,
                      device=x.device)
    if out.numel() == 0:
        return out
    if T == 0:
        raise ValueError("resample: an empty input has no samples to weigh")
    rows = x.reshape(-1, T)
    tile, span = geometry(ratio, taps)
    err = _cuda.library().lora_resample(
        rows.data_ptr(), rows.shape[0], T, rows.stride(0), rows.stride(1),
        table.data_ptr(), M, taps, weights.data_ptr(), tile, span,
        out.data_ptr(), _cuda.stream(x.device))
    _cuda.check(err, "lora_resample")
    _cuda.launched(resample)
    return out


resample.launches = 0
