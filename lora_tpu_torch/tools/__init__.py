"""Twins of lora_tpu's measurement tools (tools/*.py), driving the port.

    python -m lora_tpu_torch.tools.<name> [--device cpu] ...

bench_sensitivity, run_sensitivity_campaign, bench_e2e, bench_soft,
bench_decode and bench_stream keep their counterpart's file name, options
and JSON keys, with --device in place of --cpu: each runs on the card and,
without one, raises unless the CPU is asked for.  Their files go under
build/lora_tpu_torch/ (OUT_DIR), never into docs/."""

from __future__ import annotations

import pathlib

import torch

from ..ops._cuda import BUILD_DIR

REPO = BUILD_DIR.parents[1]
OUT_DIR = BUILD_DIR
DOCS = REPO / "docs"


def pick_device(name: str | None, prog: str) -> torch.device:
    """The device a tool runs on: `name`, or the card; without a card and
    without a name it raises, naming --device cpu."""
    if name is None and not torch.cuda.is_available():
        raise RuntimeError(f"{prog}: no CUDA device; it runs on the card.  "
                           "Pass --device cpu to run it on the CPU")
    return torch.device("cuda" if name is None else name)


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return device.type
    from ..benchmarks import card_line

    return card_line()


def out_path(path) -> pathlib.Path:
    """An output file, its directory made; never one under docs/."""
    p = pathlib.Path(path).resolve()
    if p == DOCS or DOCS in p.parents:
        raise ValueError(f"{p}: the port's tools never write into docs/")
    p.parent.mkdir(parents=True, exist_ok=True)
    return p


def time_calls(fn, reps: int) -> list[float]:
    """ms of `reps` calls of fn on the host clock after one warm-up call;
    fn ends by reading a result back to the host, so each call's device
    work is done when it returns."""
    import time

    fn()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def spread(ms: list[float]) -> dict:
    """The median, min and max of timed calls, in ms."""
    import statistics

    return {"ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms), "calls": len(ms)}


def bench_bank(B: int, sf: int, device, sigma: float):
    """The benches' SF `sf` CR 4/8 bank of 32-byte frames (the
    benchmark's: payloads from numpy's generator seeded 0, noise from a
    torch.Generator seeded 0 on the device).  -> (cfg, x complex64 [B, T]
    on the device, payloads uint8 [B, 32])."""
    from .. import benchmarks
    from ..models.demodulator import required_samples

    cfg = benchmarks.bench_cfg(sf)
    x = benchmarks.build_input(cfg, B, required_samples(cfg), device, sigma)
    return cfg, x, benchmarks.payloads(B)


def gate(dec, payloads, tag: str) -> None:
    """Every frame decoded byte-exactly, or AssertionError."""
    from ..api import extract_payloads

    got = extract_payloads(dec)
    bad = [i for i, p in enumerate(payloads) if got[i] != bytes(p.tolist())]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} of {len(got)} bench frames "
                             f"not decoded byte-exactly (first {bad[:8]})")
