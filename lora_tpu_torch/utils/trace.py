"""Profiling and frame event records (port of lora_tpu/utils/trace.py).

  - `profile(dir)` records a region with torch.profiler (CPU activity, and
    the card's kernels when there is a card) and writes a Chrome trace into
    `dir` (open it in Perfetto, chrome://tracing or TensorBoard);
    `session()` is that recording, which keeps every kernel of the region
    where torch.profiler alone drops a session's first ones, and
    `launches(prof)` counts the port's kernels in it.
  - `span(name)` marks a stretch of the program's host code in whatever
    torch.profiler session records in the process (`session`, `profile`,
    or a caller's own), on its clock beside the card's kernels; with no
    session recording it is one shared no-op, and costs a flag test.
  - `frame_events(dem, cfg)` turns a DemodResult bank into one record per
    found frame, the counterpart of the reference's stream labels.
"""

from __future__ import annotations

import contextlib
import os
import re
import socket
import time
from typing import Iterator

import numpy as np
import torch
from torch.profiler import record_function


# torch.profiler on the card drops the first device records of a session,
# more the longer the process has run: none in its first minute, 5 at 80 s,
# 15 at 200 s (NVIDIA H100 80GB HBM3, torch 2.11, CUDA 12.8;
# tools/torch_kernel_probe.py --trace).  Sessions opened one after another
# drop more, now and then: 2% to 3% of them lost 8 to 755 of their first
# records (1,200 sessions of 1,024 launches and 630 of 4,096, each with one
# kernel after them, which was never lost), and one session of a card test
# run lost more than 1,024.  A sleep or a spin on the card before the
# region does not help; launches before it take the drop in the region's
# place.  So a session on the card starts with ABSORB launches of a kernel
# of its own and a sync, and one of them at least must be left in the
# record: else the region's first kernels may be gone too, and the session
# raises.
ABSORB = 4096
ABSORB_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
ABSORB_RANGE = "absorb profiler drop"


def absorbing(name: str) -> bool:
    """Whether a profiler event or key of that name is a session's opening
    launches or their range, which a breakdown of the region leaves out."""
    return ABSORB_KERNEL in name or name == ABSORB_RANGE


# what span() returns when no profiler records: one shared no-op context
_OFF = contextlib.nullcontext()


def span(name: str):
    """A torch.profiler range `name` while a profiler records in the
    process, else the shared no-op context.  The program's spans:
    `lora.demodulate`, `lora.channelized_demodulate`, `lora.decode` (an
    entry point's whole host path) and, on the card, `lora.program:<fn>`
    around a captured program's call with its children
    `lora.program.lookup`, `.capture`, `.copy_in`, `.launch`, `.clone_out`
    (utils/jit.py)."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF


@contextlib.contextmanager
def session() -> Iterator["torch.profiler.profile"]:
    """A torch.profiler session of CPU activity, and of the card's when
    there is a card, whose device record holds every kernel the region
    launched: it opens with ABSORB launches of ABSORB_KERNEL (under the
    range ABSORB_RANGE), and raises RuntimeError when the record kept none
    of them.  Yields the profiler; its results hold those launches and
    their range, which the caller leaves out by `absorbing`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if cuda:
            with record_function(ABSORB_RANGE):
                for _ in range(ABSORB):
                    torch.cuda._sleep(0)
                torch.cuda.synchronize()
        yield prof
    if cuda and not any(ABSORB_KERNEL in e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA):
        raise RuntimeError(
            f"torch.profiler dropped all {ABSORB} launches that open the "
            f"session, and maybe the region's first kernels after them")


# the port's kernel families: the profiler names their kernels
# lora::<family>_kernel, or lora::<family>_<route>_kernel for kernel D's
# routes, with template arguments where the kernel has them
KERNELS = ("detect", "track", "payload", "channelize", "shift", "modulate",
           "decode", "resample")
_KERNEL = re.compile(r"(?:void )?lora::([a-z]+)_(?:[a-z]+_)?kernel"
                     r"(<[^(]*>)?(?:\(|$)")


def kernel_launches(names) -> dict:
    """Launches of the port's kernels among device kernel names as
    torch.profiler records them: {family: launches} for every family of
    KERNELS, and "blocked": kernel R's register-blocked launches, the
    templated `lora::resample_kernel<P, Q, TAPS>` (its general route is
    the untemplated one), which "resample" counts too.  A session's absorb
    launches and every kernel outside lora:: count for none."""
    out = dict.fromkeys(KERNELS + ("blocked",), 0)
    for name in names:
        m = _KERNEL.match(name)
        if m is None or m[1] not in KERNELS:
            continue
        out[m[1]] += 1
        if m[1] == "resample" and m[2]:
            out["blocked"] += 1
    return out


def launches(prof) -> dict:
    """kernel_launches over the device kernels a finished `session`
    recorded: zeros for each family where there is no card."""
    from torch.autograd import DeviceType

    return kernel_launches(e.name for e in prof.events()
                           if e.device_type == DeviceType.CUDA)


@contextlib.contextmanager
def profile(trace_dir: str | None) -> Iterator[None]:
    """torch.profiler trace around a region (a `session`), written as
    `<host>_<pid>.<ns>.pt.trace.json` into trace_dir (made if missing) when
    the region ends; None disables.  A profiler that fails raises, and so
    does the region: it is not run again untraced."""
    if not trace_dir:
        yield
        return
    with session() as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.pt.trace.json"))


def frame_events(dem, cfg) -> list[dict]:
    """One record per found frame of a (batched) DemodResult, with
    lora_tpu's keys: channel (the flat index over the leading axes), event,
    t_preamble, t_sync, symbols, snr_db, power_db, cfo_bins, fine_cfo."""
    col = lambda t: t.detach().reshape(-1).cpu().numpy()
    found, t_sync, count = col(dem.found), col(dem.t_sync), col(dem.count)
    snr, power = col(dem.snr), col(dem.power)
    freq, fine = col(dem.freq_error), col(dem.fine_freq)
    out = []
    for b in np.flatnonzero(found):
        out.append({
            "channel": int(b),
            "event": "frame",
            "t_preamble": int(t_sync[b]) - cfg.preamble_symbols * cfg.N,
            "t_sync": int(t_sync[b]),
            "symbols": int(count[b]),
            "snr_db": float(snr[b]),
            "power_db": float(power[b]),
            "cfo_bins": int(freq[b]),
            "fine_cfo": float(fine[b]),
        })
    return out
