"""Headline benchmark of the port: demodulator throughput on one card
(port of lora_tpu/benchmarks.py).

    python -m lora_tpu_torch.benchmarks [--device cpu] [--validate]

Prints ONE JSON line:

    {"metric": "demod_throughput_sf10", "value", "unit": "Msamples/s/chip",
     "vs_baseline", "mode", "batch", "rungs", "backend", "device"}

metric  : batched full-frame demodulation (dechirp, FFT, peak search, sync
          search, CFO recovery) at the reference's verified operating point,
          SF10 CR 4/8, 32-byte frames, complex64 samples in device memory.
value   : Msamples/s of baseband demodulated by the card: B * T over the
          median time of one `api.demodulate` call with `found` read back
          to the host (lora_tpu's serial mode), the best SF10 rung.
vs_baseline : value / 0.5, the reference's real-time need of one channel at
          its widest bandwidth times oversampling (BASELINE.md, "Required
          complex-sample throughput"): how many such modems one card serves.
rungs   : every rung's median, min and max ms over CALLS calls after one
          warm-up call (which builds and loads the kernels), and its
          Msamples/s; the SF12 rung is recorded there only.
device  : the card's name and power limit as nvidia-smi gives them.

Every frame of a bank must sync before anything is timed.  The noise is
made on the device from a torch.Generator seeded 0, so it is not lora_tpu's
PRNGKey(0) noise; the payloads and the modulated frames are the same.
A rung that fails raises: the record then has value 0.0 and "error", and
the run exits non-zero; nothing moves on to another mode.  Without a card
the benchmark refuses to run unless the CPU is asked for (--device cpu, or
LORA_BENCH_FORCE=cpu as for lora_tpu): then it prints the CPU record, SF10
at B = 8 over 2 calls of the plain route, with "backend": "cpu".
--validate also prints {"check": "bf16_vs_f32_decisions", "ok": ...} on
stderr: fused="bf16" against "auto" on the SF10 bank.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

METRIC = "demod_throughput_sf10"
UNIT = "Msamples/s/chip"
BASELINE_MSPS = 0.5
SIGMA = 0.1
PAYLOAD_BYTES = 32
# (SF, fused mode, batch), cheapest first: the plain route as the floor,
# then the kernels at two batches, then SF12 (N = 4096), recorded apart
RUNGS = ((10, "off", 512), (10, "auto", 2048), (10, "auto", 4096),
         (12, "auto", 1024))
CALLS = 7
CPU_BATCH = 8
CPU_CALLS = 2


def bench_cfg(sf: int):
    """SF, CR 4/8, amplitude 1, mtu for a 32-byte payload plus 4 symbols
    (lora_tpu/benchmarks.py:233-235)."""
    from .config import LoRaConfig

    cfg = LoRaConfig(sf=sf, cr="4/8", ampl=1.0)
    return cfg.replace(mtu=cfg.num_symbols(PAYLOAD_BYTES) + 4)


def payloads(B: int) -> np.ndarray:
    """The bank's payload bytes, uint8 [B, 32], as lora_tpu draws them."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (B, PAYLOAD_BYTES), dtype=np.uint8)


def build_input(cfg, B: int, T: int, device, sigma: float = SIGMA):
    """The bank (lora_tpu/benchmarks.py:91-105): B frames encoded,
    modulated and zero-padded to T on `device`, plus complex noise of
    sigma per component from a torch.Generator seeded 0 on that device."""
    from . import api

    x = api.modulate(api.encode(payloads(B), cfg, device=device), cfg)
    x = torch.nn.functional.pad(x, (0, max(0, T - x.shape[-1])))[:, :T]
    if sigma:
        g = torch.Generator(device=x.device).manual_seed(0)
        noise = torch.complex(
            torch.randn((B, T), generator=g, device=x.device),
            torch.randn((B, T), generator=g, device=x.device))
        x = x + sigma * noise
    return x.contiguous()


def sync_all(x, cfg, fused: str):
    """One demodulate call (the warm-up: it builds and loads the kernels);
    raises unless every frame syncs.  -> the DemodResult."""
    from . import api

    dem = api.demodulate(x, cfg, fused=fused)
    found = dem.found.cpu()
    if not bool(found.all()):
        raise AssertionError(f"fused={fused}: bench frames must all sync "
                             f"({int(found.sum())} of {found.numel()} did)")
    return dem


def run_rung(x, cfg, fused: str, calls: int) -> dict:
    """Warm up and check, then time `calls` calls of demodulate with
    `found` read back each call.  -> the rung's record."""
    from . import api

    sync_all(x, cfg, fused)
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        api.demodulate(x, cfg, fused=fused).found.cpu()
        ms.append((time.perf_counter() - t0) * 1e3)
    B, T = x.shape
    median = float(np.median(ms))
    return {"sf": cfg.sf, "mode": fused, "batch": B, "samples": T,
            "calls": calls, "median_ms": median, "min_ms": min(ms),
            "max_ms": max(ms), "msamples_s": B * T / (median * 1e-3) / 1e6}


def decisions_equal(x, cfg) -> bool:
    """fused="bf16" against "auto" on one bank: symbols, count and found
    equal (lora_tpu/benchmarks.py:496-504)."""
    a, b = (sync_all(x, cfg, f) for f in ("auto", "bf16"))
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("symbols", "count", "found"))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def measure(device: torch.device, validate: bool) -> dict:
    """Every rung on `device` (the CPU record's one rung on the CPU) ->
    the record."""
    from .models.demodulator import required_samples

    on_cpu = device.type == "cpu"
    rungs = ((10, "auto", CPU_BATCH),) if on_cpu else RUNGS
    calls = CPU_CALLS if on_cpu else CALLS
    records = {}
    for sf, fused, B in rungs:
        cfg = bench_cfg(sf)
        x = build_input(cfg, B, required_samples(cfg), device)
        if validate and sf == 10 and B == max(r[2] for r in rungs):
            print(json.dumps({"check": "bf16_vs_f32_decisions",
                              "ok": decisions_equal(x, cfg)}),
                  file=sys.stderr, flush=True)
        records[f"sf{sf}-{fused}/B{B}"] = run_rung(x, cfg, fused, calls)
        del x
    best = max((r for r in records.values() if r["sf"] == 10),
               key=lambda r: r["msamples_s"])
    return {
        "metric": METRIC,
        "value": best["msamples_s"],
        "unit": UNIT,
        "vs_baseline": best["msamples_s"] / BASELINE_MSPS,
        "mode": best["mode"],
        "batch": best["batch"],
        "rungs": records,
        "backend": device.type,
        "device": "cpu" if on_cpu else card_line(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lora_tpu_torch.benchmarks",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' prints "
                         "the CPU record)")
    ap.add_argument("--validate", action="store_true",
                    help="check fused='bf16' decisions against 'auto' "
                         "first (on stderr)")
    args = ap.parse_args(argv)
    name = args.device
    if name is None and os.environ.get("LORA_BENCH_FORCE") == "cpu":
        name = "cpu"
    if name is None and not torch.cuda.is_available():
        raise RuntimeError("lora_tpu_torch.benchmarks: no CUDA device; the "
                           "benchmark measures the card.  Pass --device cpu "
                           "(or set LORA_BENCH_FORCE=cpu) for the CPU record")
    device = torch.device("cuda" if name is None else name)
    try:
        rec = measure(device, args.validate)
    except Exception as e:  # the record says why; the run still fails
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": UNIT,
                          "vs_baseline": 0.0,
                          "error": f"{type(e).__name__}: {e}"[:300]}),
              flush=True)
        raise
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
