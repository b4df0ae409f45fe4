"""The readings that the limits of phybench/limits/ are set from.

    python3 -m phybench.calibrate --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--out FILE]

For every seed of --seeds, one run of the cell as the benchmark makes it
(a short window, no warm-up seconds) prints the numbers compared with the
plain reference:
the program's readings.  For every seed of --control-seeds, the control in
the program's place prints the same numbers: the control named by the
traffic file's `control`, "reference-bf16" (the plain reference with every
transform's operands rounded to bfloat16, the precision below the
configuration's float32) or "program-bf16" (the program's own bfloat16
route, fused="bf16").  A limit lies above the largest program reading and
below the smallest control reading (PERF.md).  One JSON line a reading;
the benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def control_numbers(cell, seed: int, seconds: float, dev) -> dict:
    from . import compare, harness
    from .generators import bank
    from .trace import Tracer

    r = harness.Run(cell, seed, seconds, False, dev, time.perf_counter(),
                    Tracer(False, ""))
    kind = cell.traffic["control"]
    bk = bank.Banks(r, fused="bf16" if kind == "program-bf16" else None)
    numbers = []
    for i, x in enumerate(bk.banks):
        if kind == "program-bf16":
            dem = bk.call(x)
            out = bank._held(bk.host(dem, bk.decode(dem.symbols)))
        else:
            out = bk.reference(i, bf16=True)
        numbers += bk.numbers([out], bk.reference(i))
    bk.readback = None
    bank._release(dev)
    return compare.worst(numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phybench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from . import device, harness

    cell = harness.Cell(args.workload).override(traffic={"warmup_s": 0.0})
    device.require_cards(torch, cell.chips)
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    with (open(args.out, "a") if args.out else contextlib.nullcontext()) \
            as out:
        for kind, seed in ([("program", s) for s in seeds]
                           + [("control", s) for s in controls]):
            _reading(cell, kind, seed, args.seconds, dev, out)
    return 0


def _reading(cell, kind: str, seed: int, seconds: float, dev, out) -> None:
    """One reading of the program or of the control, printed and written."""
    from . import harness

    t = time.perf_counter()
    extra = {}
    if kind == "program":
        res = harness.execute(cell, seed, seconds, False, dev, t)
        numbers = {k: v for k, (v, _) in res["checks"].items()}
        extra = {"metrics": {k: m["value"] for k, m in res["metrics"].items()},
                 "notes": res["notes"], "failed": res["failed"],
                 "attempted": res["attempted"]}
    else:
        numbers = control_numbers(cell, seed, seconds, dev)
    line = json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                       "numbers": numbers,
                       "seconds": time.perf_counter() - t, **extra})
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


if __name__ == "__main__":
    sys.exit(main())
