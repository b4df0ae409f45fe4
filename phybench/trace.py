"""The traced run's profiler session and the reading of its trace.

`Tracer` opens a torch.profiler session over a steady stretch of a run and
names the harness's own spans in it (`span`, a record_function range; a
no-op when the run is not traced).  `Trace` holds the session's Chrome
trace events and the reductions the per-layer metrics read: device time by
kernel name, the device time that the harness's spans launched, the busy
share of the window, and the breakdown (the device operations that took
the most time, the longest idle gaps by what the host was doing).

The absorb logic is a copy of lora_tpu_torch/utils/trace.py (`session`,
`absorbing`): torch.profiler on the card drops a session's first device
records, more the older the process, so a session opens with ABSORB
launches of a spin kernel, which the reductions leave out.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os

ABSORB = 1024
ABSORB_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
ABSORB_RANGE = "absorb profiler drop"
WINDOW = "phybench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def absorbing(name: str) -> bool:
    return ABSORB_KERNEL in name or name == ABSORB_RANGE


class Tracer:
    """Spans and, when `on`, one profiler session; the trace is written to
    `path` when the session ends."""

    def __init__(self, on: bool, path: str):
        self.on = on
        self.path = path
        self._prof = None
        self._window = None

    def span(self, name: str):
        if not self.on or self._prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def start(self) -> None:
        """Open the session: the absorbing launches, then the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if not self.on:
            return
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        with record_function(ABSORB_RANGE):
            for _ in range(ABSORB):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        self._window = record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        """Close the window after the device is done, close the session and
        write its Chrome trace."""
        import torch

        if self._prof is None:
            return
        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof = None

    def load(self) -> "Trace":
        with open(self.path) as f:
            return Trace(json.load(f)["traceEvents"])


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    """A kernel's name without its signature."""
    name = name.split("(")[0].strip()
    return name[5:] if name.startswith("void ") else name


class Trace:
    """Chrome trace events of one session, cut to its window (microseconds
    on the trace's own clock)."""

    def __init__(self, events: list):
        self.events = [e for e in events if e.get("ph") == "X"]
        win = [e for e in self.events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if win:
            self.t0 = float(win[0]["ts"])
            self.t1 = self.t0 + float(win[0]["dur"])
        else:
            ts = [float(e["ts"]) for e in self.events]
            self.t0, self.t1 = min(ts), max(float(e["ts"]) + float(e["dur"])
                                            for e in self.events)
        self.device = [e for e in self.events
                       if e.get("cat") in DEVICE_CATS
                       and not absorbing(str(e.get("name", "")))
                       and float(e["ts"]) < self.t1
                       and float(e["ts"]) + float(e["dur"]) > self.t0]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy(self):
        return _merge([[max(float(e["ts"]), self.t0),
                        min(float(e["ts"]) + float(e["dur"]), self.t1)]
                       for e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def idle_share(self):
        """Percent of the window in which no device operation ran; None
        for a window without one."""
        if not self.device or self.t1 <= self.t0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels(self, names) -> list:
        """Device kernels in the window whose name holds one of `names`."""
        return [e for e in self.device if e.get("cat") == "kernel"
                and any(n in str(e.get("name", "")) for n in names)]

    def seconds(self, events) -> float:
        return sum(float(e["dur"]) for e in events) * 1e-6

    def spans(self, name: str) -> list:
        """The harness's spans of that name in the window."""
        return [e for e in self.events if e.get("name") == name
                and e.get("cat") == "user_annotation"
                and self.t0 <= float(e["ts"]) <= self.t1]

    def launched_in(self, spans) -> list:
        """Device operations launched by host calls inside any of `spans`
        (on the span's thread), matched by their correlation id."""
        calls: dict = {}
        for e in self.events:
            if (e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})):
                calls.setdefault(e.get("tid"), []).append(
                    (float(e["ts"]), e["args"]["correlation"]))
        for v in calls.values():
            v.sort()
        corr = set()
        for sp in spans:
            row = calls.get(sp.get("tid"), [])
            a = float(sp["ts"])
            i = bisect.bisect_left(row, (a, -1))
            j = bisect.bisect_right(row, (a + float(sp["dur"]), float("inf")))
            corr.update(c for _, c in row[i:j])
        return [e for e in self.device
                if e.get("args", {}).get("correlation") in corr]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time, and the longest idle
        gaps of the window, each named by the innermost harness span (else
        host operation) running at the gap's start."""
        by_name: dict = {}
        for e in self.device:
            k = _short(str(e.get("name", "")))
            by_name[k] = by_name.get(k, 0.0) + float(e["dur"]) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self._busy()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        host = [e for e in self.events
                if e.get("cat") in ("user_annotation", "cpu_op")
                and e.get("name") not in (WINDOW, ABSORB_RANGE)]

        def doing(t):
            inside = [e for e in host if float(e["ts"]) <= t
                      < float(e["ts"]) + float(e["dur"])]
            spans = [e for e in inside if e.get("cat") == "user_annotation"]
            pick = spans or inside
            if not pick:
                return "host"
            return str(min(pick, key=lambda e: float(e["dur"]))["name"])

        idle = [[doing(a), (b - a) * 1e-6] for a, b in gaps]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}
