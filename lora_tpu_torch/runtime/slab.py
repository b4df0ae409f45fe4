"""Slab execution: demodulate channel banks larger than one call (port of
lora_tpu/runtime/slab.py).

A host bank of any B is demodulated in slabs of a fixed size on the
device, so that its memory holds one slab at a time (BASELINE.json
configs 4-5: 10k+ concurrent channels on one card).  On the card each slab
goes through a pinned staging buffer (runtime/staging.py); the last slab
is zero-padded to the slab size, so that every slab has one shape.

The run is bound by the host.  Filling a slab, the conversion of planar
host arrays into a complex64 buffer, takes far longer than the slab's
device work, so a thread fills slab k+1 while slab k is copied,
demodulated and read back.  Slab k+1 is copied and launched before slab k
is read back, but `demodulate` itself blocks the host on the copies of its
squelch threshold: by the time it returns, most of its kernels have run,
and only the tail of slab k+1's work overlaps slab k's readback.  On one
stream the copy of a slab cannot overlap the kernels of the one before
(`chip_smoke.py --profile`, step 6b, measures both: the device's idle
share and the copy time over kernels).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import LoRaConfig
from ..models.demodulator import DemodResult, demodulate, required_samples
from ..ops import cplx
from .staging import Staging


def _to_host(dem: DemodResult) -> DemodResult:
    return DemodResult(**{
        f.name: None if getattr(dem, f.name) is None
        else getattr(dem, f.name).cpu() for f in dataclasses.fields(dem)})


def demodulate_bank(re: np.ndarray, im: np.ndarray, cfg: LoRaConfig,
                    slab: int = 4096, max_frames: int = 1,
                    device=None) -> DemodResult:
    """Demodulate a host bank [B, T] (planar float32 re, im) of any B in
    slabs of `slab` channels on `device` (the card when None).  Returns a
    DemodResult of CPU tensors of leading dim B; each row is what
    demodulate gives for it (padding rows report found=False and are
    dropped).  Buffers shorter than required_samples are zero-padded."""
    dev = cplx.resolve_device(device)
    re = np.asarray(re, np.float32)
    im = np.asarray(im, np.float32)
    B, T = re.shape
    Tp = max(T, required_samples(cfg))
    staging = Staging(2) if dev.type == "cuda" else None

    def fill(s: int):
        """Slab at channel s into a (pinned) host buffer -> (slot, buffer)."""
        n = min(slab, B - s)
        if staging is None:
            slot, host = None, torch.empty((slab, Tp), dtype=torch.complex64)
        else:
            slot, host = staging.take((slab, Tp))
        torch.complex(torch.from_numpy(re[s : s + n]),
                      torch.from_numpy(im[s : s + n]), out=host[:n, :T])
        host[n:] = 0
        host[:n, T:] = 0
        return slot, host

    outs: list = []
    pending = None
    with ThreadPoolExecutor(1) as filler:
        ahead = filler.submit(fill, 0)
        for s in range(0, B, slab):
            slot, host = ahead.result()
            if s + slab < B:
                ahead = filler.submit(fill, s + slab)
            x = host.to(dev, non_blocking=slot is not None)
            if slot is not None:
                staging.sent(slot, dev)
            r = demodulate(x, cfg, max_frames=max_frames)
            if pending is not None:
                outs.append(_to_host(pending))  # slab k is read after k+1
            pending = r
    if pending is not None:
        outs.append(_to_host(pending))

    def cat(name):
        parts = [getattr(o, name) for o in outs]
        return None if parts[0] is None else torch.cat(parts, 0)[:B]

    return DemodResult(**{f.name: cat(f.name)
                          for f in dataclasses.fields(DemodResult)})
