"""Live tap view for streaming runs (headless terminal dashboard); a copy of
lora_tpu/utils/live.py that reads the step's tensors through `.cpu()`.

The reference wires the demodulator's debug taps and stream labels into
interactive GUI plotters — spectral waterfalls plus a logic-analyzer lane
of state labels (`LoRaDemod.cpp:81-83,314-324`, `examples/rx_RN2483.pth`).
This module is the equivalent for watching a live
`runtime.StreamDemodulator` run without a GUI: an ANSI terminal dashboard
updated after every device step, showing per-channel SNR sparklines, sync
activity, frame events with payload status, and stream progress.

Usage::

    view = LiveTapView(channels=4)
    sd = StreamDemodulator(cfg, channels=4, observer=view)
    ... feed()/run() loop ...      # dashboard repaints on every step

`render()` returns the dashboard as plain text (what the tests pin);
`update(...)` is the StreamDemodulator observer hook.  Writing targets any
file object — a real terminal gets in-place repaints via ANSI cursor
control, a pipe/file gets one frame of text per step.
"""

from __future__ import annotations

import sys
from collections import deque
from typing import Optional

import numpy as np

from ..ops.cplx import host

_SPARKS = "▁▂▃▄▅▆▇█"


def _spark(vals, lo=-25.0, hi=15.0) -> str:
    """SNR history (dB) -> a unicode sparkline."""
    out = []
    for v in vals:
        t = (min(max(v, lo), hi) - lo) / (hi - lo)
        out.append(_SPARKS[int(t * (len(_SPARKS) - 1) + 0.5)])
    return "".join(out)


class LiveTapView:
    """Observer for StreamDemodulator: per-step terminal dashboard."""

    def __init__(
        self,
        channels: int,
        out=None,
        history: int = 32,
        max_rows: int = 16,
    ):
        self.B = channels
        self.out = out if out is not None else sys.stdout
        self.history = history
        self.max_rows = max_rows
        self.snr_hist = [deque(maxlen=history) for _ in range(channels)]
        self.frame_count = np.zeros(channels, np.int64)
        self.last_event: list[str] = ["-"] * channels
        self.steps = 0
        self.total_frames = 0
        self._painted_lines = 0

    # -- observer hook ---------------------------------------------------
    def update(self, dem, frames, offsets) -> None:
        """StreamDemodulator observer signature (dem, frames, offsets)."""
        self.steps += 1
        snr = host(dem.snr).reshape(self.B, -1)[:, 0]
        found = host(dem.found).reshape(self.B, -1).any(axis=1)
        for b in range(self.B):
            self.snr_hist[b].append(float(snr[b]))
        for f in frames:
            self.frame_count[f.channel] += 1
            self.total_frames += 1
            sym = np.asarray(f.symbols)
            head = ",".join(str(int(s)) for s in sym[:4])
            conf = (
                f" conf={f.confidence:.0f}" if f.confidence is not None
                else ""
            )
            self.last_event[f.channel] = (
                f"frame@{f.t_start} snr={f.snr:+.1f}dB "
                f"cfo={f.freq_error:+d} sym[{head},..]{conf}"
            )
        for b in range(self.B):
            if found[b] and self.frame_count[b] == 0:
                self.last_event[b] = "sync"
        self._paint(offsets)

    __call__ = update

    # -- rendering ---------------------------------------------------------
    def render(self, offsets: Optional[np.ndarray] = None) -> str:
        """The dashboard as plain text (no ANSI), one step's snapshot."""
        pos = int(offsets.min()) if offsets is not None else 0
        lines = [
            f"lora_tpu live taps  step {self.steps}  "
            f"frames {self.total_frames}  pos {pos} samp",
            f"{'ch':>4} {'snr dB':>8}  {'history':<{self.history}} "
            f"{'frames':>6}  last event",
        ]
        show = min(self.B, self.max_rows)
        for b in range(show):
            cur = self.snr_hist[b][-1] if self.snr_hist[b] else float("nan")
            lines.append(
                f"{b:>4} {cur:>+8.1f}  {_spark(self.snr_hist[b]):<{self.history}} "
                f"{int(self.frame_count[b]):>6}  {self.last_event[b]}"
            )
        if self.B > show:
            rest = self.frame_count[show:].sum()
            lines.append(f"  ... {self.B - show} more channels "
                         f"({int(rest)} frames)")
        return "\n".join(lines)

    def _paint(self, offsets) -> None:
        text = self.render(offsets)
        n = text.count("\n") + 1
        if self.out.isatty() and self._painted_lines:
            # move the cursor up and repaint in place
            self.out.write(f"\x1b[{self._painted_lines}A\x1b[J")
        self.out.write(text + "\n")
        self.out.flush()
        self._painted_lines = n
