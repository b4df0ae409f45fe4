"""Arbitrary-ratio polyphase resampler, capture rate -> channel rate (port of
lora_tpu/ops/resample.py).

The reference's capture harness resamples SDR captures to the LoRa
bandwidth with scipy (RN2483Capture.py:80-84); real front ends need
non-integer ratios (2.048 Msps -> 500 kHz = 4.096).  A windowed-sinc bank
of NPHASE fractional-delay subfilters (tables.resample_bank, numpy, built
once) is planned on the host in float64: output m draws from input position
m * ratio.  The plan of a call is one int32 table [2, M], each output's
first input index and its subfilter, shared by every row.  On the input's
device each output sample then gathers `taps` neighbouring inputs (clamped
to the input's ends) and weighs them with its phase's subfilter.  For
decimation (ratio > 1) the prototype's cutoff scales by 1/ratio, so the
same bank low-passes and interpolates in one pass.

The weighted sum runs over the taps in a fixed order, one product and add
per tap, so every output's arithmetic is the same whatever the number of
outputs in a call: a chunked resample_stream is bit-identical to resample
of the whole input on any device.  A CUDA tensor takes kernel R
(ops/cuda_resample.py), which sums in that order, on its register-blocked
route where the host finds the plan it built periodic (`Plan.runs`); a CPU
tensor the plain route `_apply`, one gather, product and add per tap over
the whole tensor.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from . import cplx, cuda_resample, tables
from ..utils import trace

NPHASE = tables.RESAMPLE_PHASES
TAPS = tables.RESAMPLE_TAPS
_bank = tables.resample_bank


def _taps_eff(ratio: float) -> int:
    """Taps per subfilter: TAPS, widened by the ratio for decimation and
    kept even (the prototype's centre NPHASE*taps/2 lands on a multiple of
    NPHASE only then, so that phase 0 is an exact delta)."""
    if ratio <= 1:
        return TAPS
    t = int(np.ceil(TAPS * ratio))
    return t + (t % 2)


def _plan(m0: int, M: int, ratio: float, taps: int):
    """(idx [M, taps] int64, phase [M] int64) for outputs m0..m0+M-1, in
    float64 on the host: output m draws from input position m*ratio (one
    rounding, so chunked and unchunked plans agree exactly); subfilter p
    realizes a delay of -p/NPHASE from the next integer sample."""
    pos = (m0 + np.arange(M)) * ratio
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    p = (frac * NPHASE).round().astype(np.int64)  # in [0, NPHASE]
    base = base + (p > 0)
    phase = (NPHASE - p) % NPHASE
    center = taps // 2
    idx = base[:, None] + (np.arange(taps)[None, :] - center)  # [M, taps]
    return idx, phase


def _table(m0: int, M: int, ratio: float, origin: int = 0) -> np.ndarray:
    """The plan of outputs m0..m0+M-1 as the table the routes read: int32
    [2, M], each output's first input index relative to `origin` (the
    global index of the input's sample 0) and its subfilter."""
    idx, phase = _plan(m0, max(M, 0), ratio, _taps_eff(ratio))
    table = np.stack([idx[:, 0] - origin, phase])
    if table.size and np.abs(table).max() >= 2**31:
        raise ValueError("resample: input indices beyond int32")
    # below the input's first sample only at the stream's head (global 0)
    if origin and table.size and table[0].min() < 0:
        raise ValueError("resample: the carried history is too short")
    return table.astype(np.int32)


class Plan(NamedTuple):
    """A call's plan on a device: `table`, int32 [2, M] (`_table`), and
    `runs`, kernel R's register-blocked route for it
    (cuda_resample.runs), or None for its general route."""

    table: torch.Tensor
    runs: cuda_resample.Runs | None


def _on(table: np.ndarray, ratio: float, device) -> Plan:
    return Plan(torch.from_numpy(table).to(device),
                cuda_resample.runs(table, _taps_eff(ratio)))


@functools.lru_cache(maxsize=16)
def plan_on(m0: int, M: int, ratio: float, origin: int,
            device: torch.device) -> Plan:
    """The Plan of outputs m0..m0+M-1 (`_table`) on `device`, made once
    for a call's geometry."""
    return _on(_table(m0, M, ratio, origin), ratio, device)


def _cutoff(ratio: float) -> tuple[int, int]:
    """The bank's cutoff num/den of the input Nyquist: 1/ratio when
    decimating, the whole band otherwise."""
    return (1000, int(round(1000 * ratio))) if ratio > 1 else (1, 1)


def _weights(ratio: float) -> np.ndarray:
    """The ratio's bank, float32 [NPHASE, taps] on the host (cached)."""
    return _bank(*_cutoff(ratio), _taps_eff(ratio))


@functools.lru_cache(maxsize=None)
def weights_on(ratio: float, device: torch.device) -> torch.Tensor:
    """The ratio's bank, float32 [NPHASE, taps] on `device`."""
    return torch.from_numpy(_weights(ratio)).to(device)


def _apply(x: torch.Tensor, table: torch.Tensor, ratio: float
           ) -> torch.Tensor:
    """The plain route: complex64 [..., T] at the plan `table` (int32
    [2, M] on x's device; each output's taps clamped to [0, T - 1]) ->
    complex64 [..., M]."""
    dev = x.device
    taps = _taps_eff(ratio)
    start, phase = table.long()
    ii = (start[:, None] + torch.arange(taps, device=dev)).clamp_(
        0, x.shape[-1] - 1)
    w = weights_on(ratio, dev)[phase]  # [M, taps]
    xr = torch.view_as_real(x)  # [..., T, 2]: both planes with one index
    acc = None
    for j in range(taps):  # a fixed order: the same sum for any M
        term = xr[..., ii[:, j], :] * w[:, j, None]
        acc = term if acc is None else acc + term
    return torch.view_as_complex(acc.contiguous())


def weigh(x: torch.Tensor, plan: Plan, ratio: float,
          plain: bool = False) -> torch.Tensor:
    """complex64 [..., T] at `plan` (its table on x's device) -> complex64
    [..., M]: kernel R for a CUDA tensor, on the plan's route; the plain
    route for a CPU tensor or where `plain`.  All sum alike, bit for
    bit."""
    if x.is_cuda and not plain:
        return cuda_resample.resample(x, plan.table,
                                      weights_on(ratio, x.device), ratio,
                                      plan.runs, _weights(ratio))
    return _apply(x, plan.table, ratio)


def resample(x, ratio: float, out_len: int | None = None,
             device=None) -> torch.Tensor:
    """Resample complex IQ [..., T] by `ratio` input samples per output
    sample (ratio > 1 decimates) -> complex64 [..., M].  A tensor is
    resampled where it lies; host data goes to `device` (the card when
    None)."""
    with trace.span("lora.resample"):
        x = cplx.as_iq(x, device)
        ratio = float(ratio)
        T = x.shape[-1]
        if out_len is None:
            # every output's (possibly ratio-widened) tap window inside the
            # input
            out_len = int((T - _taps_eff(ratio)) / ratio)
        return weigh(x, plan_on(0, out_len, ratio, 0, x.device), ratio)


class ResampleState(NamedTuple):
    """Carried chunk-to-chunk state of :func:`resample_stream` (and of a
    block resampled by `block_plan`): the exact output-sample counter and
    the filter-history tail, so that a chunked run is bit-identical to
    resampling the whole capture at once."""

    m_next: int          # global index of the next output sample
    origin: int          # global input index of tail[..., 0]
    tail: torch.Tensor   # complex64 [..., L_tail] filter history


def history(L: int, ratio: float) -> int:
    """Samples of history a next chunk needs, of the L at hand."""
    taps = _taps_eff(ratio)
    return min(L, taps + taps // 2 + 2)


def resample_stream(x, ratio: float, state: ResampleState | None = None,
                    device=None) -> tuple[torch.Tensor, ResampleState]:
    """Streaming :func:`resample`: feed consecutive chunks [..., T_k], get
    (complex64 [..., M_k], new state).  Concatenated outputs across chunks
    are bit-identical to ``resample(concat(chunks), ratio)`` for every
    output whose tap window the stream has delivered.  The chunks and the
    state stay on the chunks' device."""
    with trace.span("lora.resample"):
        x = cplx.as_iq(x, device)
        ratio = float(ratio)
        taps = _taps_eff(ratio)
        center = taps // 2
        if state is None:
            state = ResampleState(0, 0, x.new_zeros(x.shape[:-1] + (0,)))
        local = torch.cat([state.tail.to(x.device), x], -1)
        L = local.shape[-1]
        end = state.origin + L  # global input index past the available data
        # emit every output whose full (possibly head-clipped) tap window is
        # here: the largest index it reads, floor(m*ratio) + 1 + taps-1-center,
        # must be below `end`
        hi = end - taps + center
        M = max(0, int(np.floor((hi - 1) / ratio)) + 1 - state.m_next)
        while M > 0 and np.floor((state.m_next + M - 1) * ratio) + 1 > hi:
            M -= 1  # float guard at the boundary
        if M == 0:
            out = local[..., :0]
        else:
            table = _table(state.m_next, M, ratio, state.origin)
            assert table[0].max() + taps <= L
            out = weigh(local, _on(table, ratio, x.device), ratio)
        keep = history(L, ratio)  # history for the next chunk
        new = ResampleState(state.m_next + M, end - keep,
                            local[..., L - keep:].clone())
        return out, new


def block_plan(state: ResampleState | None, M: int, ratio: Fraction,
               device: torch.device):
    """The resampling of a block of M new samples after `state` (None: the
    stream's head), every output whose position m * ratio lies inside the
    samples delivered so far, the taps past the last one clamped to it as
    `resample(out_len=...)` clamps them; the next block continues the
    output grid and reads the carried tail as its history.  `ratio` is
    exact (a Fraction) so that the count is.  -> (the Plan on `device`,
    the next state's m_next and origin).  The block's input is the tail
    then the M samples; the next state's tail is its last
    history(Lt + M, ratio) samples."""
    m_next, origin, Lt = ((0, 0, 0) if state is None else
                          (state.m_next, state.origin, state.tail.shape[-1]))
    L = Lt + M
    end = origin + L
    n = max(0, math.floor(Fraction(end) / ratio) - m_next)
    keep = history(L, float(ratio))
    return (plan_on(m_next, n, float(ratio), origin, device), m_next + n,
            end - keep)
