#!/usr/bin/env python3
"""Probe the port's window kernels (A detect, B track, C payload) on one
NVIDIA card: their registers and spills, and their times, alone or in turns
against another copy of the sources.  Every copy is first held against the
plain versions at the flagship shape by chip_smoke.py's own step 3a
(hold_window_kernels).

    python3 tools/torch_kernel_probe.py [--resources] [--sizes]
                                        [--against DIR ...] [--runs N]

--resources   compile {detect,track,payload}.cu of the tree and of every
              --against copy with `-Xptxas -v` and print every kernel's
              registers, spill bytes and static shared memory (no library is
              kept);
--sizes       hold kernels A and C (with mag2) against their plain versions
              at every window size from 64 to 4096 and time kernel A there
              (every copy in turns);
--against DIR build the kernels of DIR (a copy of lora_tpu_torch/csrc with
              the same C entry points) too and time both in turns on one
              card: DIR, tree, tree, DIR.  May be given several times.

Without --against it times the tree alone.  The bank is chip_smoke.py's
flagship bank (4096 channels, SF10, mtu 68, seed 1234); times are CUDA
events, the median of --runs (7) after a warm-up, the better of the two
turns.  Prints the card's name and power limit first.  Needs the card.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def resources(_cuda) -> None:
    """Registers, spills and shared memory of every kernel, from ptxas."""
    nvcc = _cuda._nvcc()
    procs = [(src, subprocess.Popen(
        [nvcc, *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", os.devnull,
         str(_cuda.CSRC / src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for src in ("detect.cu", "track.cu", "payload.cu")]
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
                k = re.search(r"(\w+_kernel)ILi(\d+)(?:ELb(\d))?", name)
                if k:
                    name = f"{k.group(1)}<{k.group(2)}" + (
                        f", {k.group(3)}>" if k.group(3) else ">")
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                spill = (f"stack {m.group(1)} B, spill stores {m.group(2)} B, "
                         f"loads {m.group(3)} B")
            m = re.search(r"Used (\d+) registers(?:, used \d+ barriers)?"
                          r"(?:, (\d+) bytes smem)?", line)
            if m and name:
                print(f"resources {src} {name}: {m.group(1)} registers, "
                      f"{spill}, static smem {m.group(2) or 0} B", flush=True)
                name = None


def load(_cuda, csrc):
    """The library built from the sources in `csrc`."""
    _cuda.CSRC = pathlib.Path(csrc).resolve()
    _cuda.library.cache_clear()
    return _cuda.library()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--resources", action="store_true")
    ap.add_argument("--sizes", action="store_true")
    ap.add_argument("--against", action="append", default=[])
    ap.add_argument("--runs", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_probe: no CUDA device")
    import chip_smoke as cs
    from lora_tpu_torch import api
    from lora_tpu_torch.ops import _cuda, cuda_demod, cuda_detect
    from lora_tpu_torch.ops import detect as det_ops

    cs.RUNS = args.runs
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    tree_csrc = _cuda.CSRC
    if args.resources:
        for d in [tree_csrc, *args.against]:
            _cuda.CSRC = pathlib.Path(d).resolve()
            print(f"resources of {d}:", flush=True)
            resources(_cuda)
    cached = _cuda.library
    libs = {"tree": load(_cuda, tree_csrc)}
    for d in args.against:
        libs[d] = load(_cuda, d)
    use = lambda name: setattr(_cuda, "library", lambda: libs[name])
    use("tree")

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
            _, t0, ds, fine = cs.hold_window_kernels(torch, bank, cfg, dev,
                                                     sync)
            print(f"{which}: parity ok; {int((ds % 2).sum())} of {B} data "
                  "starts odd", flush=True)
        except AssertionError as e:
            if which == "tree":
                raise
            print(f"{which}: PARITY FAILED: {e}", flush=True)
    use("tree")

    others = list(args.against)
    order = others + ["tree", "tree"] + others[::-1]
    if args.sizes:
        for n in (64, 128, 256, 512, 1024, 2048, 4096):
            m = (1 << 25) // n
            x = cs.awgn((m, n), 1.0, gen, dev)
            f = torch.rand(m, generator=gen, device=dev) - 0.5
            c = cs.Check(f"detect N={n}")
            cs.check_detect(c, det_ops, cuda_detect, x, False, f, True)
            ms = {}
            for which in order:
                use(which)
                t = cs.timed(lambda: cuda_detect.dechirp_detect(
                    x, want_f_index=False), sync)
                ms[which] = min(ms.get(which, t), t)
            use("tree")
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
            bnd = cs.bound(m * (n * 8 + 12), m * cs.window_flops(n, False))
            print(f"size N={n}: A and C parity ok ({c.ties + c2.ties} near "
                  f"ties, mag2 within {e2:.3g}); kernel A for {m} windows: "
                  + ", ".join(f"{w} {t:.3f} ms" for w, t in ms.items())
                  + f", bound {bnd['bound_ms']:.3f} ms [{card}]", flush=True)
            del x, rows, got, want

    stages = {
        "detect": lambda: cuda_detect.dechirp_detect(win, want_f_index=False),
        "track": lambda: cuda_demod.track(bank, t0, cfg.sync, cfg.thresh, N),
        "payload": lambda: cuda_demod.payload_detect(bank, ds, fine, mtu, N),
        "payload+mag2": lambda: cuda_demod.payload_detect(
            bank, ds, fine, mtu, N, want_mag2=True),
        "demodulate": lambda: api.demodulate(bank, cfg, fused="auto"),
    }
    for name, fn in stages.items():
        ms = {}
        for which in order:
            use(which)
            t = cs.timed(fn, sync)
            ms.setdefault(which, []).append(t)
        print(f"time {name}: " + ", ".join(
            f"{w} {min(t):.3f} ms ({' '.join(f'{x:.3f}' for x in t)})"
            for w, t in ms.items()) + f" [{card}]", flush=True)
    _cuda.library = cached
    return 0


if __name__ == "__main__":
    sys.exit(main())
