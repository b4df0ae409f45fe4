#!/usr/bin/env python3
"""Probe the port's kernels on one NVIDIA card: the window kernels (A
detect, B track, C payload), the filterbank (D channelize) and the
resampler (R): their registers and spills, and their times, alone or in
turns against another copy of the sources.  Every copy is first held
against the plain versions: A, B, C at the flagship shape by
chip_smoke.py's own step 3a (hold_window_kernels), D at the config-3 shape
against the plain product, R bit-equal to the plain route at the
US902-928 cell's shape (8/5) and at 4.096 on the same rows (both routes
where the copy has the register-blocked one).

    python3 tools/torch_kernel_probe.py [--resources] [--sizes]
                                        [--kernels abcdr] [--against DIR ...]
                                        [--runs N] [--trace IDLE]

--resources   compile every source of the tree and of every --against copy
              with `-Xptxas -v` and print every kernel's registers, spill
              bytes and static shared memory (no library is kept);
--kernels     which kernels to hold and time: any of a, b, c (they share the
              flagship bank), d (the config-3 stream) and r (step 13's
              rows); default a to d;
--sizes       hold kernels A and C (with mag2) against their plain versions
              at every window size from 64 to 4096 and time kernel A there,
              and hold and time kernel D at every K from 8 to 1024 and at
              K = 24, 192 (every copy in turns), its float32 route and its
              bf16 route (route 3; a copy from before route 3 is driven
              through the bf16 flag of its lora_channelize) each beside its
              bound;
--against DIR build the kernels of DIR (a copy of lora_tpu_torch/csrc) too
              and time both in turns on one card: DIR, tree, tree, DIR.  May
              be given several times.  A copy from before kernel D read
              history and block through two pointers (it exports
              lora_channelize_tile) is driven through its own entry, on the
              concatenated stream, and timed with and without the
              concatenation it needs.

--trace IDLE  instead: what torch.profiler keeps of one flagship
              demodulate(fused="auto") (kernels A, B, C and about 107 small
              launches) as the process ages: rounds of traced sessions at
              the start, after IDLE seconds without tracing and after 2 IDLE
              more.  Each round traces the call through utils.trace.profile
              and through torch.profiler alone, with nothing, a throwaway
              launch and sync, a host sleep or a 20 ms spin on the card
              between the session's start and the call; each prints the
              device events kept, kernels A, B, C among them, and how far
              the CUDA runtime's events lie before the PyTorch op that made
              them (the trace's two clocks apart).

Kernel D's bf16 route is held against filterbank_fir_plain by chip_smoke.py's
BF16_* bars (bf16_close) and timed at the config-3 shape too.

Without --against it times the tree alone.  The banks are chip_smoke.py's:
the flagship bank (4096 channels, SF10, mtu 68, seed 1234) and, for D, 256
streams of 64 x 10,240 noise samples with no history, as config 3's path
gives them.  Times are CUDA events, the median of --runs (7) after a
warm-up, the better of the two turns.  Prints the card's name and power
limit first.  Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# lora_channelize as it was while the caller concatenated history and block:
# (xp, row stride, S, K, L, M, hp, wk, y, stream)
ONE_POINTER = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
               ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + \
    [ctypes.c_void_p] * 4


def resources(_cuda) -> None:
    """Registers, spills and shared memory of every kernel, from ptxas."""
    nvcc = _cuda._nvcc()
    procs = [(src, subprocess.Popen(
        [nvcc, *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", os.devnull,
         str(_cuda.CSRC / src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for src in _cuda.SOURCES if (_cuda.CSRC / src).exists()]
    worst = 0
    for src, p in procs:
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        name = None
        spill = ""
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                k = re.search(r"\d+(\w+_kernel)(?:ILi(\d+)(?:EL[bi](\d+))?)?",
                              name)
                if k:
                    args = ", ".join(g for g in k.groups()[1:] if g)
                    name = k.group(1) + (f"<{args}>" if args else "")
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                spill = (f"stack {m.group(1)} B, spill stores {m.group(2)} B, "
                         f"loads {m.group(3)} B")
                worst = max(worst, int(m.group(2)), int(m.group(3)))
            m = re.search(r"Used (\d+) registers(?:, used \d+ barriers)?"
                          r"(?:, (\d+) bytes smem)?", line)
            if m and name:
                print(f"resources {src} {name}: {m.group(1)} registers, "
                      f"{spill}, static smem {m.group(2) or 0} B", flush=True)
                name = None
    print(f"resources: largest spill of any kernel {worst} B", flush=True)


def load(_cuda, csrc):
    """The library built from the sources in `csrc`, bound by the entry
    points it has."""
    _cuda.CSRC = pathlib.Path(csrc).resolve()
    _cuda.HEADERS = tuple(sorted(p.name for p in _cuda.CSRC.glob("*.cuh")))
    lib = ctypes.CDLL(str(_cuda.build()))
    for name, argtypes in _cuda._ARGTYPES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    if hasattr(lib, "lora_channelize_tile"):
        lib.lora_channelize.argtypes = ONE_POINTER
    return lib


def in_turns(cs, order, use, fn, sync):
    """{copy: [ms of each turn]} of fn under every library of `order`."""
    ms = {}
    for which in order:
        use(which)
        ms.setdefault(which, []).append(cs.timed(fn, sync))
    use("tree")
    return ms


def show(ms) -> str:
    return ", ".join(f"{w} {min(t):.3f} ms ({' '.join(f'{x:.3f}' for x in t)})"
                     for w, t in ms.items())


def probe_d(torch, cs, _cuda, libs, order, use, args, card, dev, sync):
    """Kernel D of every copy against the plain product and in turns."""
    from lora_tpu_torch.ops import channelizer as chz
    from lora_tpu_torch.ops import cuda_channelize as cc

    L = 8
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 10)
    current = {}
    cat_too = {"on": False}

    def run(x, K, state=None):
        """Kernel D of the library in use: through the wrapper, or through
        a one-pointer copy's own entry on the concatenated stream."""
        lib = _cuda.library()
        if not hasattr(lib, "lora_channelize_tile"):
            return cc.filterbank(x, K, L, state)
        S, T = x.shape
        M = T // K
        key = (x.data_ptr(), None if state is None else state.data_ptr())
        if cat_too["on"] or current.get("key") != key:
            current["xp"] = chz.prepended(x, state, L * K - 1)
            current["key"] = key
        xp = current["xp"]
        y = torch.empty((S, K, M), dtype=torch.complex64, device=dev)
        hp, wk = cc.consts(K, L, dev)
        _cuda.check(lib.lora_channelize(
            xp.data_ptr(), xp.stride(0), S, K, L, M, hp.data_ptr(),
            wk.data_ptr(), y.data_ptr(), _cuda.stream(dev)), "lora_channelize")
        return y

    def run_bf16(x, K, state=None):
        """Kernel D's bf16 route of the library in use: route 3 through the
        wrapper, or the flag of a copy from before it (its direct sum)."""
        lib = _cuda.library()
        if hasattr(lib, "lora_channelize_bf16"):
            return cc.filterbank(x, K, L, state, bf16=True)
        S, T = x.shape
        M = T // K
        y = torch.empty((S, K, M), dtype=torch.complex64, device=dev)
        hp, wk = cc.consts(K, L, dev)
        _cuda.check(lib.lora_channelize(
            None if state is None else state.data_ptr(),
            0 if state is None else state.stride(0), x.data_ptr(),
            x.stride(0), S, K, L, M, hp.data_ptr(), wk.data_ptr(),
            y.data_ptr(), _cuda.stream(dev), 1), "lora_channelize bf16")
        return y

    def hold(K, S, M, what):
        x = cs.awgn((S, K * M), 1.0, gen, dev)
        st = cs.awgn((S, L * K - 1), 1.0, gen, dev)
        rel = {}
        for state in (st, None):
            want = cc.filterbank_plain(chz.prepended(x, state, L * K - 1), K,
                                       L, M)
            for which in libs:
                use(which)
                c = cs.Check(f"channelize {which} K={K}")
                rel[which, state is None] = c.close_rel(
                    what, run(x, K, state), want, cs.D_RTOL)
            del want
        use("tree")
        print(f"{what}: kernel D within " + ", ".join(
            f"{w} {rel[w, False]:.3g} / {rel[w, True]:.3g}" for w in libs)
            + " of the plain product's maximum (with a state / with none)",
            flush=True)
        return x

    def hold_bf16(x, K, what):
        """Every copy's bf16 route against filterbank_fir_plain (no
        state), by chip_smoke.py's bars."""
        S, T = x.shape
        want = cc.filterbank_fir_plain(chz.prepended(x, None, L * K - 1), K,
                                       L, T // K)
        res = []
        for which in libs:
            use(which)
            if not bf16_capable(_cuda.library()):
                continue
            share, rel, same = cs.bf16_close(
                torch, cs.Check(f"channelize bf16 {which} K={K}"), what,
                run_bf16(x, K), want)
            res.append(f"{which} {share:.6f} within {cs.BF16_RTOL}, max "
                       f"{rel:.3g}, bit-equal {same}")
        use("tree")
        del want
        print(f"{what}: kernel D bf16 against filterbank_fir_plain: "
              + "; ".join(res), flush=True)

    def bf16_capable(lib):
        return (hasattr(lib, "lora_channelize_bf16")
                or not hasattr(lib, "lora_channelize_tile"))

    bf16_order = [w for w in order if bf16_capable(libs[w])]

    def bf16_bound(S, K, M):
        return cs.bound(2 * S * K * M * 8, S * K * M * 4 * L,
                        S * K * M * 8 * K)

    S, K, M = cs.C3_STREAMS, cs.C3_K, 10240
    x = hold(K, S, M, f"config-3 shape S={S} K={K} M={M}")
    bnd = cs.bound(2 * S * K * M * 8, S * K * M * (5 * math.log2(K) + 4 * L))
    ms = in_turns(cs, order, use, lambda: run(x, K), sync)
    print(f"time channelize (kernel alone): {show(ms)}, bound "
          f"{bnd['bound_ms']:.3f} ms by {bnd['bound_by']} [{card}]", flush=True)
    hold_bf16(x, K, f"config-3 shape S={S} K={K} M={M}")
    ms = in_turns(cs, bf16_order, use, lambda: run_bf16(x, K), sync)
    bnd = bf16_bound(S, K, M)
    print(f"time channelize bf16 (route {cc.route(K, L, True)}): {show(ms)}, "
          f"bound {bnd['bound_ms']:.3f} ms by {bnd['bound_by']} [{card}]",
          flush=True)
    cat_too["on"] = True
    ms = in_turns(cs, order, use, lambda: run(x, K), sync)
    cat_too["on"] = False
    print(f"time channelize (with the concatenation a one-pointer copy "
          f"needs): {show(ms)} [{card}]", flush=True)
    del x
    if args.sizes:
        for K in (8, 16, 32, 64, 128, 256, 512, 1024, 24, 192):
            M = 4101  # odd: a ragged last tile, and a small plain matrix
            S = max(1, (1 << 25) // (K * M))
            x = hold(K, S, M, f"size K={K} S={S} M={M} route "
                     f"{cc.route(K, L)}")
            hold_bf16(x, K, f"size K={K} S={S} M={M} route "
                      f"{cc.route(K, L, True)}")
            bnd = cs.bound(2 * S * K * M * 8,
                           S * K * M * (5 * math.log2(K) + 4 * L))
            ms = in_turns(cs, order, use, lambda: run(x, K), sync)
            mb = in_turns(cs, bf16_order, use, lambda: run_bf16(x, K), sync)
            bb = bf16_bound(S, K, M)
            print(f"size K={K}: kernel D for {S * K * M} samples: float32 "
                  f"(route {cc.route(K, L)}) {show(ms)}, bound "
                  f"{bnd['bound_ms']:.3f} ms; bf16 (route "
                  f"{cc.route(K, L, True)}) {show(mb)}, bound "
                  f"{bb['bound_ms']:.3f} ms by {bb['bound_by']} [{card}]",
                  flush=True)
            del x


def probe_r(torch, cs, _cuda, libs, order, use, card, dev, sync):
    """Kernel R of every copy at the US902-928 cell's shape (8/5) and at
    4.096 on the same rows, each held bit-equal to the plain route, then
    timed in turns: the register-blocked route where the copy has it
    (lora_resample_blocked), the general route beside it."""
    from lora_tpu_torch.ops import resample as rs

    g = torch.Generator(device=dev).manual_seed(cs.SEED + 130)
    x = torch.randn((cs.R_ROWS, cs.R_T), dtype=torch.complex64, device=dev,
                    generator=g)
    for ratio in (cs.R_RATIO, 4.096):
        taps = rs._taps_eff(ratio)
        M = cs.R_M if ratio == cs.R_RATIO else int((cs.R_T - taps) / ratio)
        table = rs.table_on(0, M, ratio, 0, dev)
        runs = rs.runs_on(0, M, ratio)
        want = rs.weigh(x, table, ratio, plain=True)

        def run(route):
            blocked = hasattr(_cuda.library(), "lora_resample_blocked")
            return rs.weigh(x, table, ratio,
                            runs=runs if route and blocked else None)

        for which in libs:
            use(which)
            for route in (True, False):
                if not torch.equal(run(route), want):
                    raise AssertionError(f"kernel R of {which} at {ratio} "
                                         f"(blocked {route}) differs from "
                                         "the plain route")
        use("tree")
        del want
        bnd = cs.bound(cs.R_ROWS * (cs.R_T + M) * 8,
                       4 * taps * cs.R_ROWS * M)
        for route in ((True, False) if runs else (False,)):
            ms = in_turns(cs, order, use, lambda: run(route), sync)
            print(f"time resample {ratio} ({cs.R_ROWS} x {cs.R_T} -> {M}, "
                  f"{'blocked where the copy has it' if route else 'general'}"
                  f" route, bit-equal): {show(ms)}, bound "
                  f"{bnd['bound_ms']:.3f} ms by {bnd['bound_by']} [{card}]",
                  flush=True)
    del x


def probe_trace(torch, cs, api, card, dev, sync, idle: float) -> None:
    """--trace: the device events torch.profiler keeps of one flagship call
    as the process ages, by how the session starts."""
    import json
    import tempfile
    import time

    from torch.profiler import ProfilerActivity, profile

    from lora_tpu_torch.utils import trace

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t_start = time.perf_counter()
    cfg = cs.flagship_cfg()
    bank, _ = cs.make_bank(api, cfg, cs.B_FLAGSHIP, cs.SIGMA, cs.SEED, dev)
    call = lambda: api.demodulate(bank, cfg, fused="auto")
    call()
    sync()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    spin = 40_000_000  # cycles: about 20 ms at the H100's 1.98 GHz
    one = torch.ones(1, device=dev)

    def launches(n):
        for _ in range(n):
            one.add_(0)
        sync()

    def empty_session():
        with profile(activities=acts):
            pass

    before = {
        "nothing": lambda: None,
        "launch+sync": lambda: launches(1),
        "32 launches+sync": lambda: launches(32),
        "256 launches+sync": lambda: launches(256),
        "sleep 20 ms": lambda: time.sleep(20e-3),
        "spin 20 ms": lambda: torch.cuda._sleep(spin),
    }
    young = {}

    def kept(path, how):
        """Print what the trace kept; -> its device events' names."""
        with open(path) as f:
            ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        dev_ev = sorted((e for e in ev if e.get("cat") in (
            "kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])
        names = [e["name"][:32] for e in dev_ev]
        abc = {k: sum(f"{k}_kernel" in n for n in names)
               for k in ("detect", "track", "payload")}
        # the CUDA runtime's events against the op that made them, and the
        # device's against their launch (the trace's clocks apart)
        ops = {e["args"]["External id"]: e["ts"] for e in ev
               if e.get("cat") == "cpu_op" and "External id" in e.get("args",
                                                                      {})}
        rt = [e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        gap = sorted(e["ts"] - ops[e["args"]["External id"]] for e in rt
                     if e.get("args", {}).get("External id") in ops)
        corr = lambda e: e.get("args", {}).get("correlation")
        by_corr = {corr(e): e["ts"] for e in rt}
        lag = sorted(e["ts"] - by_corr[corr(e)] for e in dev_ev
                     if corr(e) in by_corr)
        first = min(e["ts"] for e in ev)
        q = lambda v: (f"{v[0]:.1f} / {v[len(v) // 2]:.1f}" if v else "none")
        print(f"  {how}: {len(dev_ev)} device events, kernels {abc}; runtime "
              f"event after its op (least / median) {q(gap)} us; device "
              f"event after its launch {q(lag)} us; first device event "
              f"{(dev_ev or ev)[0]['ts'] - first:.1f} us into the trace",
              flush=True)
        ref = young.setdefault(how, names)
        if names != ref:
            missing, j = [], 0
            for i, n in enumerate(ref):
                if j < len(names) and names[j] == n:
                    j += 1
                else:
                    missing.append(f"{i}:{n}")
            print(f"    missing against the first round (position in time: "
                  f"name): {missing}", flush=True)

    def session(tmp, how, first):
        if how == "hook":
            with trace.profile(tmp):
                call()
                sync()
        else:
            if how == "after an empty session":
                empty_session()
            with profile(activities=acts) as prof:
                first()
                call()
                sync()
            prof.export_chrome_trace(os.path.join(tmp, "t.pt.trace.json"))
        (name,) = os.listdir(tmp)
        kept(os.path.join(tmp, name), how)

    def rounds(when):
        age = time.perf_counter() - t_start
        print(f"{when} (process {age:.0f} s) [{card}]", flush=True)
        for how, first in [("hook", None), *before.items(),
                           ("after an empty session", lambda: None)]:
            with tempfile.TemporaryDirectory() as tmp:
                session(tmp, how, first)

    rounds("at the start")
    time.sleep(idle)
    rounds(f"after {idle:.0f} s idle")
    time.sleep(2 * idle)
    rounds(f"after {2 * idle:.0f} s more")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--resources", action="store_true")
    ap.add_argument("--sizes", action="store_true")
    ap.add_argument("--kernels", default="abcd")
    ap.add_argument("--against", action="append", default=[])
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--trace", type=float, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_probe: no CUDA device")
    import chip_smoke as cs
    from lora_tpu_torch import api
    from lora_tpu_torch.benchmarks import card_line
    from lora_tpu_torch.ops import _cuda, cuda_demod, cuda_detect
    from lora_tpu_torch.ops import detect as det_ops

    cs.RUNS = args.runs
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    if args.trace is not None:
        probe_trace(torch, cs, api, card, dev, sync, args.trace)
        return 0
    tree_csrc, tree_headers = _cuda.CSRC, _cuda.HEADERS
    if args.resources:
        for d in [tree_csrc, *args.against]:
            _cuda.CSRC = pathlib.Path(d).resolve()
            print(f"resources of {d}:", flush=True)
            resources(_cuda)
    cached = _cuda.library
    libs = {"tree": load(_cuda, tree_csrc)}
    for d in args.against:
        libs[d] = load(_cuda, d)
    _cuda.CSRC, _cuda.HEADERS = tree_csrc, tree_headers
    use = lambda name: setattr(_cuda, "library", lambda: libs[name])
    use("tree")
    others = list(args.against)
    order = others + ["tree", "tree"] + others[::-1]

    if "d" in args.kernels:
        probe_d(torch, cs, _cuda, libs, order, use, args, card, dev, sync)
    if "r" in args.kernels:
        probe_r(torch, cs, _cuda, libs, order, use, card, dev, sync)
    if not set("abc") & set(args.kernels):
        _cuda.library = cached
        return 0

    cfg = cs.flagship_cfg()
    N, mtu = cfg.N, cfg.mtu
    bank, _ = cs.make_bank(api, cfg, cs.B_FLAGSHIP, cs.SIGMA, cs.SEED, dev)
    B, T = bank.shape
    W = T // N
    win = bank[:, : W * N].reshape(B, W, N)

    # parity at the flagship shape of every copy: chip_smoke.py's step 3a
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    for which in libs:
        use(which)
        try:
            _, t0, ds, fine, _ = cs.hold_window_kernels(torch, bank, cfg, dev,
                                                        sync)
            print(f"{which}: parity ok; {int((ds % 2).sum())} of {B} data "
                  "starts odd", flush=True)
        except AssertionError as e:
            if which == "tree":
                raise
            print(f"{which}: PARITY FAILED: {e}", flush=True)
    use("tree")

    if args.sizes:
        for n in (64, 128, 256, 512, 1024, 2048, 4096):
            m = (1 << 25) // n
            x = cs.awgn((m, n), 1.0, gen, dev)
            f = torch.rand(m, generator=gen, device=dev) - 0.5
            c = cs.Check(f"detect N={n}")
            cs.check_detect(c, det_ops, cuda_detect, x, False, f, True)
            ms = in_turns(cs, order, use, lambda: cuda_detect.dechirp_detect(
                x, want_f_index=False), sync)
            rows = x.reshape(m // 8, 8 * n)
            d0 = torch.randint(0, n, (m // 8,), generator=gen, device=dev)
            fr = torch.rand(m // 8, generator=gen, device=dev) * 4 - 2
            got = cuda_demod.payload_detect(rows, d0, fr, 7, n, want_mag2=True)
            want = cuda_demod.payload_detect_plain(rows, d0, fr, 7, n,
                                                   want_mag2=True)
            c2 = cs.Check(f"payload N={n}")
            okk = c2.values(got[0], want[0],
                            lambda i: want[3].reshape(-1, n)[i])
            c2.close("power", got[1], want[1], mask=okk)
            e2 = cs.windows_close(f"mag2 N={n}", got[3], want[3])
            # kernel B at this size: candidates of 18 noise windows
            cand = x.reshape(-1, 32 * n)
            t00 = torch.randint(0, 14 * n, (cand.shape[0],), generator=gen,
                                device=dev, dtype=torch.int32)
            kb = cuda_demod.track(cand, t00, 0x12, cfg.thresh, n)
            pb = cuda_demod.track_plain(cand, t00, 0x12, cfg.thresh, n)
            c3 = cs.Check(f"track N={n}")
            for fld in ("synced", "k_sync"):
                c3.equal(fld, kb[fld], pb[fld])
            mb = in_turns(cs, order, use, lambda: cuda_demod.track(
                cand, t00, 0x12, cfg.thresh, n), sync)
            bnd = cs.bound(m * (n * 8 + 12), m * cs.window_flops(n, False))
            print(f"size N={n}: A and C parity ok ({c.ties + c2.ties} near "
                  f"ties, mag2 within {e2:.3g}); kernel A for {m} windows: "
                  f"{show(ms)}, bound {bnd['bound_ms']:.3f} ms; kernel B for "
                  f"{cand.shape[0]} candidates of noise (all 13 steps): "
                  f"{show(mb)} [{card}]", flush=True)
            del x, rows, got, want, cand

    stages = {
        "a": ("detect", lambda: cuda_detect.dechirp_detect(
            win, want_f_index=False)),
        "b": ("track", lambda: cuda_demod.track(bank, t0, cfg.sync,
                                                cfg.thresh, N)),
        "c": ("payload", lambda: cuda_demod.payload_detect(bank, ds, fine,
                                                           mtu, N)),
        "c2": ("payload+mag2", lambda: cuda_demod.payload_detect(
            bank, ds, fine, mtu, N, want_mag2=True)),
        "e2e": ("demodulate", lambda: api.demodulate(bank, cfg, fused="auto")),
    }
    for key, (name, fn) in stages.items():
        if key[0] in args.kernels or key == "e2e":
            print(f"time {name}: {show(in_turns(cs, order, use, fn, sync))} "
                  f"[{card}]", flush=True)
    _cuda.library = cached
    return 0


if __name__ == "__main__":
    sys.exit(main())
