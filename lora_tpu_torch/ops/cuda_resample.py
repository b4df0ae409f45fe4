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

Two routes, two kernels of one name, chosen by `runs` from the plan table
the host builds.  The general route takes any plan: a thread an output,
its taps read from the tile's span in shared memory.  There, at 8/5, the
shared and L1 data path (about six wavefronts a warp a tap) and not the
bytes sets the pace: 3.55 to 3.6 ms at the US902-928 cell's shape, 58% of
the 2.083-ms bound.  The register-blocked route takes a plan that repeats
every P outputs and Q inputs at one of the kernel's instances (`BLOCKED`:
8/5 and 5/8): a thread forms a run of consecutive outputs from one window
of inputs in registers, with the period's weights as kernel parameters,
so each staged sample is read about once and the bytes are left to bound
it.

`resample` launches it on a CUDA tensor or raises; ops/resample.py takes
the plain route for a tensor that lies on the CPU.  `resample.launches`
counts its launches, `resample.blocked` those of the register-blocked
route.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda, tables

TILE = 1024           # outputs a block, at most
SMEM_TILE = 64 << 10  # shared memory a tile may take before it is halved
SMEM_MAX = 227 << 10  # the most a block can opt in to

# the register-blocked route's instances in csrc/resample.cu: (period P
# outputs, its Q inputs, taps)
BLOCKED = {(5, 8, 14), (8, 5, 8)}
PERIOD_MAX = max(p for p, _, _ in BLOCKED)
RUN = 2    # periods a thread's run
WARPS = 8  # a block's warps


def smem(tile: int, span: int) -> int:
    """Bytes of a block's shared memory on the general route
    (csrc/resample.cu): the tile's plan and its span."""
    return tile * 8 + span * 8


def geometry(ratio: float, taps: int) -> tuple[int, int]:
    """(tile, span) of the general route: outputs a block and the input
    samples a tile spans at most.  Outputs m and m + d of a plan start at
    most floor(d * ratio) + 2 inputs apart (each rounds its position down
    and may move up one); two samples more cover the host's float64
    rounding."""
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


class Runs(NamedTuple):
    """The register-blocked route for one plan: its period (P outputs over
    `advance` = Q inputs), its taps, `align`, the table's first output of
    phase 0 (< P), the subfilters of outputs align .. align + P - 1, and a
    block's shared memory in bytes."""

    period: int
    advance: int
    taps: int
    align: int
    phases: tuple
    smem: int


def offsets(P: int, Q: int) -> list[int]:
    """First inputs of a period's P outputs past that of its output of
    phase 0, as ops/resample.py `_plan` places them at the ratio Q / P in
    exact arithmetic (csrc/resample.cu `Runs::off`): the position's integer
    part, one more where its fraction rounds to a phase above 0."""
    n = tables.RESAMPLE_PHASES
    return [i * Q // P + ((2 * (i * Q % P) * n + P) // (2 * P) > 0)
            for i in range(P)]


def blocked_smem(P: int, Q: int, taps: int) -> int:
    """Bytes of a block's shared memory on the register-blocked route
    (csrc/resample.cu `Runs::SMEM`): for each warp two buffers of its 32
    runs' inputs, PAD samples after each run's, and its outputs at an odd
    pitch."""
    inputs = RUN * Q
    window = (RUN - 1) * Q + offsets(P, Q)[-1] + taps
    pad = 2 if inputs % 4 == 0 else 0
    span = 31 * inputs + window
    ibuf = (span + pad * (span // inputs) + 3) & ~1
    obuf = (32 * (RUN * P | 1) + 1) & ~1
    return WARPS * (2 * ibuf + obuf) * 8


def runs(table: np.ndarray, taps: int) -> Runs | None:
    """The register-blocked route for the plan `table` (int32 [2, M]: each
    output's first input and its subfilter) at `taps` taps, or None for the
    general route.  Blocked where the table repeats with a period of P <=
    PERIOD_MAX outputs (every phase P outputs on the same, every first
    input Q further) at an instance of the kernel (`BLOCKED`), and the
    period's offsets from its output of phase 0 are those the kernel forms
    (`offsets`)."""
    start, phase = np.asarray(table, np.int64)
    M = start.size
    for P in range(1, min(PERIOD_MAX, M - 1) + 1):
        Q = int(start[P] - start[0])
        if (np.array_equal(phase[P:], phase[:-P])
                and np.all(start[P:] - start[:-P] == Q)):
            break
    else:
        return None
    zero = np.flatnonzero(phase[:P] == 0)
    if (P, Q, taps) not in BLOCKED or not zero.size:
        return None
    a = int(zero[0])
    if a + P > M or list(start[a : a + P] - start[a]) != offsets(P, Q):
        return None
    return Runs(P, Q, taps, a, tuple(int(p) for p in phase[a : a + P]),
                blocked_smem(P, Q, taps))


def resample(x: torch.Tensor, table: torch.Tensor, weights: torch.Tensor,
             ratio: float, runs: Runs | None = None,
             bank: np.ndarray | None = None) -> torch.Tensor:
    """Kernel R wrapper: complex64 [..., T] on the card (any strides) at
    the plan `table` (int32 [2, M] on the same card: each output's first
    input, its taps clamped to [0, T - 1], and its subfilter), weighed by
    `weights` (float32 [NPHASE, taps]) -> complex64 [..., M], contiguous.
    With `runs` (`runs(table)`, None for the general route) the
    register-blocked route, which takes the period's weights from `bank`,
    the same bank on the host."""
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
    lib = _cuda.library()
    if runs is None:
        tile, span = geometry(ratio, taps)
        err = lib.lora_resample(
            rows.data_ptr(), rows.shape[0], T, rows.stride(0), rows.stride(1),
            table.data_ptr(), M, taps, weights.data_ptr(), tile, span,
            out.data_ptr(), _cuda.stream(x.device))
    else:
        if runs.taps != taps or bank is None or bank.shape != weights.shape:
            raise ValueError("resample: the blocked route needs the plan's "
                             "taps and the bank on the host")
        wts = np.ascontiguousarray(bank[list(runs.phases)], np.float32)
        err = lib.lora_resample_blocked(
            rows.data_ptr(), rows.shape[0], T, rows.stride(0), rows.stride(1),
            table.data_ptr(), M, taps, weights.data_ptr(), runs.period,
            runs.advance, runs.align, wts.ctypes.data, runs.smem,
            out.data_ptr(), _cuda.stream(x.device))
    _cuda.check(err, "lora_resample")
    _cuda.launched(resample)
    if runs is not None:
        _cuda.launched(resample, "blocked")
    return out


resample.launches = 0
resample.blocked = 0
