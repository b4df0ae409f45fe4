"""Marginal cost of the decoder at bank scale (port of
tools/bench_decode.py).

    python -m lora_tpu_torch.tools.bench_decode [--B 2048] [--reps 7]
        [--device cpu]

Times, on an SF10 bank of B channels (32-byte frames, AWGN 0.05; SF7 and
B = 4 on the CPU unless --B is given): (a) demodulate alone, (b)
demodulate + decode, (c) decode alone on symbols already on the device.
Gate first: demodulate + decode must give every frame byte-exactly.  Each
stage's record gives the median, min and max ms of --reps calls (after a
warm-up) with a result read back; (c) adds µs a frame and decode's
marginal cost, (b) - (a).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import bench_bank, device_label, gate, pick_device, spread, time_calls

SIGMA = 0.05


def measure(B: int, sf: int, device, reps: int) -> list[dict]:
    """The three stages' records (printed too)."""
    from .. import api

    cfg, x, pay = bench_bank(B, sf, device, SIGMA)
    label = device_label(device)
    gate(api.decode(api.demodulate(x, cfg).symbols, cfg), pay,
         "demod+decode")
    sym = api.demodulate(x, cfg).symbols
    recs = []
    for stage, fn in (
            ("demod only", lambda: api.demodulate(x, cfg).found.cpu()),
            ("demod+decode", lambda: api.decode(
                api.demodulate(x, cfg).symbols, cfg).status.cpu()),
            ("decode only", lambda: api.decode(sym, cfg).status.cpu())):
        rec = {"stage": stage, **spread(time_calls(fn, reps))}
        if stage == "decode only":
            rec["us_per_frame"] = rec["ms"] / B * 1e3
            rec["marginal_decode_ms"] = recs[1]["ms"] - recs[0]["ms"]
        rec.update(B=B, sf=sf, device=label)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lora_tpu_torch.tools.bench_decode",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--B", type=int, default=None,
                    help="channels (2048; 4 on the CPU)")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    device = pick_device(args.device, "bench_decode")
    on_card = device.type == "cuda"
    measure(args.B or (2048 if on_card else 4), 10 if on_card else 7, device,
            args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
