"""Pinned host buffers that carry host blocks to the card.

A copy from pinned host memory with non_blocking=True returns before the
card has read the buffer.  Writing the next block into the same buffer
then may change a block already handed to the card.  So every buffer here
is used in turn, a CUDA event is recorded on the copying stream after each
copy from it (`sent`), and `take` waits on that event before the buffer is
written again.  `take` may run in an ingest thread while `sent` runs in
the thread that issues the copies: a buffer is handed out again only after
its last copy was issued and its event recorded.
"""

from __future__ import annotations

import threading

import torch


class Staging:
    """n pinned buffers (complex64 unless `take` asks for another dtype),
    handed out in turn."""

    def __init__(self, n: int):
        self._bufs: list = [None] * n
        self._copied: list = [None] * n  # CUDA event after the last copy
        self._issued = [threading.Event() for _ in range(n)]
        for e in self._issued:
            e.set()
        self._next = 0

    def take(self, shape, stop: threading.Event | None = None,
             dtype: torch.dtype = torch.complex64):
        """-> (slot, pinned tensor of `shape` and `dtype`) to be written and
        copied, then released by sent(slot); None if `stop` is set while
        the slot's last copy is still to be issued.  Its contents are
        whatever the slot held before."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        while not self._issued[i].wait(0.2):
            if stop is not None and stop.is_set():
                return None
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        self._issued[i].clear()
        n = 1
        for s in shape:
            n *= s
        buf = self._bufs[i]
        if buf is None or buf.dtype != dtype or buf.numel() < n:
            self._bufs[i] = buf = torch.empty(n, dtype=dtype,
                                              pin_memory=True)
        return i, buf[:n].view(shape)

    def reserve(self, shape, dtype: torch.dtype = torch.complex64) -> None:
        """Pin every slot's buffer for blocks of `shape` now, before a timed
        run (pinning takes host time), rather than at its first take."""
        n = 1
        for s in shape:
            n *= s
        for i, buf in enumerate(self._bufs):
            if buf is None or buf.dtype != dtype or buf.numel() < n:
                self._bufs[i] = torch.empty(n, dtype=dtype, pin_memory=True)

    def sent(self, slot: int, device: torch.device) -> None:
        """Record that a copy from `slot` was issued on `device`'s current
        stream: the slot is written again only after that copy is done."""
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        self._copied[slot] = ev
        self._issued[slot].set()
