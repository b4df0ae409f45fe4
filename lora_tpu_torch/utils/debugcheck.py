"""Opt-in numeric sanitizer for the demod path (port of
lora_tpu/utils/debugcheck.py).

A NaN or Inf that enters the pipeline propagates through dechirp -> |FFT|^2
-> argmax and comes out as a plausible-looking, wrong symbol stream.
``debug_checks()`` arms host-side finite and range assertions on every
``demodulate`` result:

    with lora_tpu_torch.debug_checks():
        dem = lora_tpu_torch.demodulate(iq, cfg)  # raises on NaN/Inf/garbage

Checked per call, on the found lanes: power, snr and fine CFO are finite;
symbols lie in [0, 2^sf); t_sync and consumed lie inside the buffer; the
payload spectra (fft_mag2) are finite and non-negative (demodulate carries
them while checks are armed).

This is a debug mode: each call waits for the device and copies its
result to the host.  Arming is scoped to the arming thread or context (a
ContextVar), so a concurrent ingest or device thread keeps its
unsynchronized path.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np

from ..ops.cplx import host

_ARMED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "lora_torch_debug_checks", default=False
)


def armed() -> bool:
    """True while inside a debug_checks() context (in this thread/context)."""
    return _ARMED.get()


@contextlib.contextmanager
def debug_checks():
    """Context manager arming numeric sanitizer checks on demodulate()."""
    token = _ARMED.set(True)
    try:
        yield
    finally:
        _ARMED.reset(token)


class DemodCheckError(AssertionError):
    """A demodulate() output failed the armed numeric sanitizer."""


def _fail(what: str, where) -> None:
    idx = np.argwhere(where)
    raise DemodCheckError(
        f"demodulate sanitizer: {what} at lane(s) {idx[:8].tolist()}"
        + (" ..." if len(idx) > 8 else "")
    )


def check_demod(res, cfg, T: int) -> None:
    """Host-side assertions on a DemodResult (leading axes arbitrary) of
    buffers of T samples."""
    found = host(res.found)
    for name in ("power", "snr", "fine_freq"):
        bad = ~np.isfinite(host(getattr(res, name))) & found
        if bad.any():
            _fail(f"non-finite {name}", bad)
    syms = host(res.symbols)
    bad = ((syms < 0) | (syms >= cfg.N)) & found[..., None]
    if bad.any():
        _fail(f"symbol out of [0, {cfg.N})", bad.any(axis=-1))
    for name in ("t_sync", "consumed"):
        a = host(getattr(res, name))
        bad = ((a < 0) | (a > T)) & found
        if bad.any():
            _fail(f"{name} outside buffer", bad)
    if res.fft_mag2 is not None:
        m = host(res.fft_mag2)
        bad = (~np.isfinite(m) | (m < 0)).any(axis=(-1, -2)) & found
        if bad.any():
            _fail("non-finite/negative payload spectra", bad)
