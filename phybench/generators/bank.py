"""The closed-loop bank generator: one caller, one call at a time.

A call hands the program a bank and takes back decoded payloads with their
frames' fields on the host: `api.demodulate(bank)` (traffic entry
"demodulate", a [channels, T] bank) or `api.channelized_demodulate(block,
K)` (entry "channelized_demodulate", a [streams, M*K] wideband block, a
frame on every channel), then `api.decode(symbols)`, then every field
copied without blocking into pinned host buffers made at set-up, and one
synchronize; the caller looks at a call's results while the card runs the
next call.  The banks rotate among `banks` distinct ones made at set-up
from the seed.  Set-up ends with `warmup_s` seconds of such calls.

msamples_per_s is the complex input samples of every call that completed
inside the window over the window's length.  Every call's payloads are
held against its bank's first call's as they come, and once the window has
closed against the payloads sent (`failed`); a sample of the calls drawn
from the seed, with each bank's first call, is held channel by channel,
every channel, against the plain reference (phybench/compare.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, inputs
from ..reference import channelizer as rch
from ..reference import rx
from ..reference.lora import required_samples

KEEP_P = 1 / 128     # share of the window's calls kept for the reference
KEEP_MAX = 48        # kept calls beyond each bank's first
REF_ROWS = 1024      # reference rows (channels or streams' channels) a block
PAYLOAD = ("status", "offset", "length", "data")  # every call's, judged
JUDGED_ONLY = ("symbols", "count", "fine_freq")  # read back when judged


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fields(dem, dec) -> dict:
    """A call's results by name: the decode's, then the demodulator's."""
    return ({k: getattr(dec, k) for k in compare.DECODE}
            | {k: getattr(dem, k) for k in compare.DEMOD})


class Readback:
    """Host buffers for a call's results, pinned on the card's host and
    made once: `start` copies a call's fields into them without blocking,
    `wait` waits once and gives the call's arrays, views of the buffers
    that the next `start` on them overwrites."""

    def __init__(self, fields: dict, dev):
        pin = dev.type == "cuda"
        self.buf = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                    for k, t in fields.items()}
        self.view = {k: b.numpy() for k, b in self.buf.items()}
        self.dev = dev
        self.keys = ()

    def twin(self) -> "Readback":
        return Readback(self.buf, self.dev)

    def start(self, fields: dict, judged: bool) -> None:
        """The decoded payloads and statuses and the frame fields a
        gateway forwards with them; a judged call also its symbols, count
        and fine CFO."""
        self.keys = [k for k in fields if judged or k not in JUDGED_ONLY]
        for k in self.keys:
            self.buf[k].copy_(fields[k], non_blocking=True)

    def wait(self) -> dict:
        if self.dev.type == "cuda":
            torch.cuda.current_stream(self.dev).synchronize()
        return {k: self.view[k] for k in self.keys}

    def blank(self) -> dict:
        """Host arrays for a kept call, every page written now: a page
        first written inside the window costs the host a fault there."""
        out = {k: np.empty_like(v) for k, v in self.view.items()}
        for v in out.values():
            v.fill(0)
        return out


def _delivered(out: dict, sent: np.ndarray) -> int:
    """Frames of `sent` [n, L], one a channel of the call's flattened
    channels, delivered OK with their payload byte-exact."""
    n, L = out["status"].size, sent.shape[-1]
    st, off, ln = (out[k].reshape(n) for k in ("status", "offset", "length"))
    data = out["data"].reshape(n, -1)
    o = int(off[0])
    if np.all(off == o):
        eq = np.all(data[:, o : o + L] == sent, 1)
    else:
        idx = np.minimum(off[:, None] + np.arange(L), data.shape[-1] - 1)
        eq = np.all(np.take_along_axis(data, idx, 1) == sent, 1)
    return int(np.count_nonzero((st == 0) & (ln == L) & eq))


class Banks:
    """A cell's banks made from the seed, what was sent on them, and the
    program's call."""

    def __init__(self, r, fused: str = None):
        from lora_tpu_torch import api

        from ..harness import program_config

        cell, dev = r.cell, r.dev
        self.cfg = cfg = cell.radio()
        self.pcfg = pcfg = program_config(cfg)
        self.conf = conf = cell.config
        self.entry = entry = cell.traffic["entry"]
        fused = fused or "auto"
        imp = cell.traffic["impair"]
        self.nbytes = nbytes = conf["radio"]["payload_bytes"]
        g = inputs.generator(r.seed, dev)
        self.banks, self.sent = [], []
        n = cell.traffic["banks"]
        if entry == "demodulate":
            B = conf["channels"]
            T = required_samples(cfg)
            for _ in range(n):
                x, p = inputs.bank(cfg, B, nbytes, imp, g, dev)
                self.banks.append(x)
                self.sent.append(p)
            self.samples = B * T
            self.shapes = {"detect": (B, T, cfg.N)}
            self.call = lambda x: api.demodulate(x, pcfg, fused=fused)
        elif entry == "channelized_demodulate":
            S, K, L = conf["streams"], conf["K"], conf["taps_per_phase"]
            M = required_samples(cfg)
            for _ in range(n):
                x, p = inputs.wideband(cfg, S, K, L, nbytes, imp, g, dev)
                self.banks.append(x)
                self.sent.append(p.reshape(-1, nbytes))
            self.samples = S * M * K
            self.shapes = {"detect": (S * K, M, cfg.N),
                           "channelize": (S, M * K, K, L)}
            self.call = lambda x: api.channelized_demodulate(
                x, K, pcfg, L, fused=fused)[0]
        else:
            raise ValueError(f"bank generator: unknown entry {entry!r}")
        self.decode = lambda s: api.decode(s, pcfg)
        self.readback = None

    def host(self, dem, dec, judged: bool = True) -> dict:
        """A call's results on the host, read back through one buffer."""
        f = _fields(dem, dec)
        if self.readback is None:
            self.readback = Readback(f, dem.found.device)
        self.readback.start(f, judged)
        return self.readback.wait()

    def numbers(self, outs: list, ref: dict) -> list:
        S = self.cfg.num_symbols(self.nbytes)
        return [compare.bank_numbers(o, ref, S) for o in outs]

    def reference(self, i: int, bf16: bool = False) -> dict:
        return reference(self.banks[i], self.cfg, self.entry, self.conf,
                         bf16)


def _held(out: dict, slot: dict = None) -> dict:
    """A call's arrays copied out of the read-back buffers, into `slot`
    (Readback.blank) where one is given."""
    if slot is None:
        return {k: v.copy() for k, v in out.items()}
    for k, v in out.items():
        np.copyto(slot[k], v)
    return {k: slot[k] for k in out}


def run(r) -> dict:
    dev, tracer = r.dev, r.tracer
    bk = Banks(r)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def submit(x, judged, rb):
        with tracer.span("phybench.demodulate"):
            dem = bk.call(x)
        with tracer.span("phybench.decode"):
            dec = bk.decode(dem.symbols)
        with tracer.span("phybench.readback"):
            rb.start(_fields(dem, dec), judged)

    # warm-up: every bank's shapes and captures, then calls for the
    # traffic's warm-up seconds (PERF.md: a fresh process's first seconds
    # of calls run slower)
    for x in bk.banks:
        dem = bk.call(x)
        bk.host(dem, bk.decode(dem.symbols))
    # two read-back buffers: the caller looks at a call's results while
    # the card runs the next call, one call on the card at a time
    bufs = [bk.readback, bk.readback.twin()]
    slots = [bk.readback.blank() for _ in range(len(bk.banks) + KEEP_MAX)]
    t_warm = time.perf_counter() + r.cell.traffic["warmup_s"]
    n = 0
    while time.perf_counter() < t_warm:
        submit(bk.banks[n % len(bk.banks)], False, bufs[n % 2])
        bufs[n % 2].wait()
        n += 1
    warm_calls = n
    _sync(dev)
    keep_rng = np.random.default_rng([r.seed, 1])
    kept, first, differ, ends = [], {}, [], []
    per_bank = [0] * len(bk.banks)

    def examine(i, is_first, keep, out):
        if is_first:
            first[i] = _held(out, slots.pop())
            return
        if not all(np.array_equal(out[k], first[i][k]) for k in PAYLOAD):
            differ.append((i, _held({k: out[k] for k in PAYLOAD})))
        if keep:
            kept.append((i, _held(out, slots.pop())))

    # a traced run profiles a shorter stretch: its trace stays small
    window_s = (min(r.seconds, r.cell.traffic["trace_seconds"]) if r.trace
                else r.seconds)
    tracer.start()
    t0 = time.perf_counter()
    setup_s = t0 - r.t_start
    deadline = t0 + window_s
    n = n_kept = 0
    seen, pending = set(), None
    while True:
        i = n % len(bk.banks)
        keep = i not in seen or (n_kept < KEEP_MAX
                                 and keep_rng.random() < KEEP_P)
        rb = bufs[n % 2]
        n += 1
        submit(bk.banks[i], keep, rb)
        if pending is not None:
            with tracer.span("phybench.examine"):
                examine(*pending)
            pending = None
        out = rb.wait()
        end = time.perf_counter()
        inside = end <= deadline
        if not inside and i in seen:
            break
        if inside:
            ends.append(end)
            per_bank[i] += 1
        # each bank's first call is judged, also one that ends after the
        # window's close (a window too short for every bank)
        n_kept += keep and i in seen
        pending = (i, i not in seen, keep, out)
        seen.add(i)
    if pending is not None:
        examine(*pending)
    calls = len(ends)
    tracer.stop()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del out, bufs
    bk.readback = None
    _release(dev)
    # every call's payloads: a call whose payloads equal its bank's first
    # call's delivered what that call delivered
    attempted = calls * bk.sent[0].shape[0]
    once = {i: _delivered(o, bk.sent[i]) for i, o in first.items()}
    delivered = sum(n * once[i] for i, n in enumerate(per_bank) if n)
    delivered += sum(_delivered(o, bk.sent[i]) - once[i] for i, o in differ)
    numbers = []
    for i in range(len(bk.banks)):
        outs = [first[i]] + [o for j, o in kept if j == i]
        numbers += bk.numbers(outs, bk.reference(i))
    return {"e2e": {"msamples_per_s": calls * bk.samples / window_s / 1e6},
            "setup_s": setup_s, "attempted": attempted,
            "failed": attempted - delivered,
            "numbers": compare.worst(numbers), "shapes": bk.shapes,
            "memory_peak_bytes": int(peak),
            "notes": {"calls": calls, "warmup_calls": warm_calls,
                      "judged_calls": len(numbers),
                      "calls_unlike_their_banks_first": len(differ),
                      "calls_by_second": np.bincount(
                          (np.asarray(ends) - t0).astype(int)
                      ).tolist()}}


def _release(dev) -> None:
    """Free the program's captured graphs and their memory before the
    reference runs."""
    from lora_tpu_torch.utils import jit

    jit.clear()
    if dev.type == "cuda":
        _sync(dev)
        torch.cuda.empty_cache()


def reference(x, cfg, entry: str, conf: dict, bf16: bool = False) -> dict:
    """The plain reference's demod and decode fields of one bank or
    wideband block, on x's device, in blocks of rows."""
    if entry == "channelized_demodulate":
        K, L = conf["K"], conf["taps_per_phase"]
        step = max(1, REF_ROWS // K)
        parts = []
        for s in range(0, x.shape[0], step):
            y = rch.channelize(x[s : s + step], K, L)
            parts.append(reference(y.reshape(-1, y.shape[-1]), cfg,
                                   "demodulate", conf, bf16))
        out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        return {k: v.reshape(x.shape[0], K, *v.shape[1:])
                for k, v in out.items()}
    parts = []
    for i in range(0, x.shape[0], REF_ROWS):
        d = rx.demodulate(x[i : i + REF_ROWS], cfg, bf16=bf16)
        dec = rx.decode(d["symbols"], cfg)
        parts.append({k: v.cpu().numpy() for k, v in {**d, **dec}.items()})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
