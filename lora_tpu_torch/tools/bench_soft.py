"""Soft-decision RX cost at bank scale (port of tools/bench_soft.py).

    python -m lora_tpu_torch.tools.bench_soft [--B 2048] [--reps 7]
        [--device cpu]

Times three paths on an SF10 bank of B channels (32-byte frames, AWGN
0.1; SF7 and B = 4 on the CPU unless --B is given):
  (a) hard RX: demodulate + decode;
  (b) soft RX: demodulate(spectra=True) + decode_soft, kernel C writing
      the payload |X|^2 windows (mag2) on the card;
  (c) soft RX with fused="off", the plain route, for attribution.
Gate first: each path must decode every frame byte-exactly before it is
timed.  Each path's record gives the median, min and max ms of --reps
calls (after a warm-up) with `found` read back, and the Gsamples/s of the
median; (b) carries the soft/hard ratio, (c) the kernels' speedup.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import bench_bank, device_label, gate, pick_device, spread, time_calls

SIGMA = 0.1


def hard(x, cfg, fused="auto"):
    from .. import api

    d = api.demodulate(x, cfg, fused=fused)
    return d, api.decode(d.symbols, cfg)


def soft(x, cfg, fused="auto"):
    from .. import api

    d = api.demodulate(x, cfg, spectra=True, fused=fused)
    return d, api.decode_soft(d.fft_mag2, cfg)


def measure(B: int, sf: int, device, reps: int) -> list[dict]:
    """The three paths' records (printed too)."""
    cfg, x, pay = bench_bank(B, sf, device, SIGMA)
    T = x.shape[1]
    label = device_label(device)
    recs = []
    for path, fn, fused in (("hard (demod+decode)", hard, "auto"),
                            ("soft fused (spectra demod + ML decode)", soft,
                             "auto"),
                            ("soft unfused (fused=off)", soft, "off")):
        gate(fn(x, cfg, fused)[1], pay, path)
        rec = {"path": path, **spread(time_calls(
            lambda: fn(x, cfg, fused)[0].found.cpu(), reps))}
        rec["Gsamp/s"] = B * T / (rec["ms"] * 1e-3) / 1e9
        if recs and fused == "auto":
            rec["soft_vs_hard"] = rec["ms"] / recs[0]["ms"]
        if fused == "off":
            rec["fused_speedup"] = rec["ms"] / recs[1]["ms"]
        rec.update(B=B, sf=sf, device=label)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lora_tpu_torch.tools.bench_soft",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--B", type=int, default=None,
                    help="channels (2048; 4 on the CPU)")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    device = pick_device(args.device, "bench_soft")
    on_card = device.type == "cuda"
    measure(args.B or (2048 if on_card else 4), 10 if on_card else 7, device,
            args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
