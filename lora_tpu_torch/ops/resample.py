"""Arbitrary-ratio polyphase resampler, capture rate -> channel rate (port of
lora_tpu/ops/resample.py).

The reference's capture harness resamples SDR captures to the LoRa
bandwidth with scipy (RN2483Capture.py:80-84); real front ends need
non-integer ratios (2.048 Msps -> 500 kHz = 4.096).  A windowed-sinc bank
of NPHASE fractional-delay subfilters (tables.resample_bank, numpy, built
once) is planned on the host in float64: output m draws from input position
m * ratio.  On the input's device each output sample then gathers `taps`
neighbouring inputs and weighs them with its phase's subfilter.  For
decimation (ratio > 1) the prototype's cutoff scales by 1/ratio, so the
same bank low-passes and interpolates in one pass.

The weighted sum runs over the taps in a fixed order, one gather, product
and add per tap, so every output's arithmetic is the same whatever the
number of outputs in a call: a chunked resample_stream is bit-identical to
resample of the whole input on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cplx, tables

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


def _apply(x: torch.Tensor, idx: np.ndarray, phase: np.ndarray,
           ratio: float, taps: int) -> torch.Tensor:
    """complex64 [..., T] at the planned input indices idx [M, taps] (in
    range) weighed by their phases' subfilters -> complex64 [..., M]."""
    num, den = (1000, int(round(1000 * ratio))) if ratio > 1 else (1, 1)
    dev = x.device
    w = torch.from_numpy(_bank(num, den, taps)[phase]).to(dev)  # [M, taps]
    ii = torch.from_numpy(idx).to(dev)
    xr = torch.view_as_real(x)  # [..., T, 2]: both planes with one index
    acc = None
    for j in range(taps):  # a fixed order: the same sum for any M
        term = xr[..., ii[:, j], :] * w[:, j, None]
        acc = term if acc is None else acc + term
    return torch.view_as_complex(acc.contiguous())


def resample(x, ratio: float, out_len: int | None = None,
             device=None) -> torch.Tensor:
    """Resample complex IQ [..., T] by `ratio` input samples per output
    sample (ratio > 1 decimates) -> complex64 [..., M].  A tensor is
    resampled where it lies; host data goes to `device` (the card when
    None)."""
    x = cplx.as_iq(x, device)
    T = x.shape[-1]
    taps = _taps_eff(ratio)
    if out_len is None:
        # every output's (possibly ratio-widened) tap window inside the input
        out_len = int((T - taps) / ratio)
    idx, phase = _plan(0, out_len, ratio, taps)
    return _apply(x, np.clip(idx, 0, T - 1), phase, ratio, taps)


class ResampleState(NamedTuple):
    """Carried chunk-to-chunk state of :func:`resample_stream`: the exact
    output-sample counter and the filter-history tail, so that a chunked
    run is bit-identical to resampling the whole capture at once."""

    m_next: int          # global index of the next output sample
    origin: int          # global input index of tail[..., 0]
    tail: torch.Tensor   # complex64 [..., L_tail] filter history


def resample_stream(x, ratio: float, state: ResampleState | None = None,
                    device=None) -> tuple[torch.Tensor, ResampleState]:
    """Streaming :func:`resample`: feed consecutive chunks [..., T_k], get
    (complex64 [..., M_k], new state).  Concatenated outputs across chunks
    are bit-identical to ``resample(concat(chunks), ratio)`` for every
    output whose tap window the stream has delivered.  The chunks and the
    state stay on the chunks' device."""
    x = cplx.as_iq(x, device)
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
        idx, phase = _plan(state.m_next, M, ratio, taps)
        idx = np.clip(idx, 0, None) - state.origin  # head clip = global 0
        assert idx.min() >= 0 and idx.max() < L
        out = _apply(local, idx, phase, ratio, taps)
    keep = min(L, taps + center + 2)  # history for the next chunk
    new = ResampleState(state.m_next + M, end - keep,
                        local[..., L - keep:].clone())
    return out, new
