"""The numbers that decide `correct`, each held against its limit.

A bank cell's numbers compare what the timed path returned for a call with
what the plain reference (phybench/reference/rx.py) gives for the same
bank, channel by channel, every channel:

  decision_diff     channels whose decisions differ: found, t_sync, count,
                    freq_error, or a symbol of the frame's own (the windows
                    past it hold noise, whose argmax is a near tie)
  payload_diff      channels whose decode differs: status, or the
                    payload's bytes where the status is OK
  estimates_parted  the share of the channels both found with equal
                    decisions whose fine CFO, SNR or power parts from the
                    reference's by more than its tolerance (TOLERANCE)

The first two are exact comparisons (limit 0).  The estimates are judged
by a share and not by their widest gap: a frame whose estimate sits at a
near tie of the receiver's tracking loop takes either of two values under
float32 rounding, in the reference as in the program (PERF.md), so the
widest gap over tens of thousands of channels swings to the size of a
lower precision's on some seeds.  The tolerances lie between the gaps that
sound runs read on every other channel and those of the lower-precision
control; the share's limit lies between the program's and the control's
readings (PERF.md).
"""

from __future__ import annotations

import numpy as np

DEMOD = ("found", "t_sync", "count", "freq_error", "fine_freq", "snr",
         "power", "symbols")
DECODE = ("data", "offset", "length", "status")
# fine_freq in bins, snr and power in dB
TOLERANCE = {"fine_freq": 1e-4, "snr": 1e-2, "power": 1e-3}


def flat(out: dict) -> dict:
    """Every field with its leading axes flattened to one row axis."""
    n = out["found"].size
    return {k: np.asarray(v).reshape(n, *np.shape(v)[np.ndim(out["found"]):])
            for k, v in out.items()}


def payload_equal(a: dict, b: dict) -> np.ndarray:
    """Rows whose status agrees and, where it is OK, whose payload bytes
    data[offset : offset + length] agree."""
    idx = np.arange(a["data"].shape[-1])
    span = lambda o: ((idx >= o["offset"][:, None])
                      & (idx < (o["offset"] + o["length"])[:, None]))
    same_span = ((a["offset"] == b["offset"]) & (a["length"] == b["length"]))
    bytes_eq = np.all(np.where(span(a), a["data"] == b["data"], True), -1)
    ok = a["status"] == 0
    return (a["status"] == b["status"]) & (~ok | (same_span & bytes_eq))


def bank_numbers(prog: dict, ref: dict, frame_symbols: int) -> dict:
    """prog, ref: the demod and decode fields of one bank (host arrays of
    the same leading shape), every channel judged."""
    p, r = flat(prog), flat(ref)
    S = frame_symbols
    same = ((p["found"] == r["found"]) & (p["t_sync"] == r["t_sync"])
            & (p["count"] == r["count"])
            & (p["freq_error"] == r["freq_error"])
            & np.all(p["symbols"][:, :S] == r["symbols"][:, :S], -1))
    out = {"decision_diff": int(np.sum(~same)),
           "payload_diff": int(np.sum(~payload_equal(p, r)))}
    both = same & r["found"]
    parted = np.zeros_like(both)
    for field, tol in TOLERANCE.items():
        d = np.abs(p[field].astype(np.float64) - r[field].astype(np.float64))
        parted |= d > tol
    out["estimates_parted"] = (float(np.sum(parted & both) / np.sum(both))
                               if both.any() else 0.0)
    return out


def worst(numbers: list) -> dict:
    """The largest reading of each number over several comparisons."""
    out: dict = {}
    for n in numbers:
        for k, v in n.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every number within its limit, {name: [number, limit]}).  A
    number without a limit, or a limit without a number, fails."""
    checks = {k: [numbers.get(k), limits.get(k)]
              for k in sorted(set(numbers) | set(limits))}
    ok = all(v is not None and lim is not None and v <= lim
             for v, lim in checks.values())
    return ok, checks
