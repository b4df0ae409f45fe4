"""The paired-sensitivity campaign (port of
tools/run_sensitivity_campaign.py): lora_tpu's matrix of operating points
through the port's bench_sensitivity, in one process.

    python -m lora_tpu_torch.tools.run_sensitivity_campaign
        [--outdir DIR] [--device cpu]
    python -m lora_tpu_torch.tools.run_sensitivity_campaign --points FILE
        [--outdir DIR] [--device cpu]
    python -m lora_tpu_torch.tools.run_sensitivity_campaign --merge DIR

The matrix (RUNS): SF 7/8/10/12 x CR 4/8 + 4/7 at 32 frames a point, hard
and soft; CR 4/5 at SF 7/10; the reference simulation topology's channel
rotation (pi/1.2345) at SF 7/10; 128 frames at the threshold points of SF7
and SF10.  Each run writes sens_<name>.json into --outdir
(build/lora_tpu_torch/sensitivity/ by default, never docs/), and the merge
combines them, later runs winning at the same point, into
sensitivity_vs_reference.json there.

--points FILE runs exactly the points of a rows file (such as the
committed docs/sensitivity_vs_reference.json), each at its row's n, hard
and soft: the 60 points lora_tpu measured, whose SF7 CR 4/5 noise 2.3 row
is a 256-frame re-run outside RUNS.  The merge prints how many points are
better, equal and worse against the reference FSM and against lora_tpu's
committed rows.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from . import OUT_DIR, out_path, pick_device

ROT = "2.544690049407732"  # pi / 1.2345 (lora_simulation.pth channel)
DEFAULT_OUTDIR = OUT_DIR / "sensitivity"

RUNS = [
    ("main", ["--sf", "7", "8", "10", "12", "--cr", "4/8", "4/7",
              "--packets", "32", "--soft"]),
    ("cr45", ["--sf", "7", "10", "--cr", "4/5", "--packets", "32",
              "--soft"]),
    ("rot", ["--sf", "7", "10", "--cr", "4/8", "--rotate", ROT,
             "--packets", "32", "--soft"]),
    ("deep7", ["--sf", "7", "--cr", "4/8", "--noise", "1.7", "2.0", "2.3",
               "--packets", "128", "--soft"]),
    ("deep10", ["--sf", "10", "--cr", "4/8", "--noise", "4.8", "5.6",
                "6.4", "--packets", "128", "--soft"]),
]


def dedup(rows: list[dict]) -> list[dict]:
    """lora_tpu's merge rule: one row per (sf, cr, noise_ampl, rotate), the
    later row winning, sorted by (sf, cr, rotate, noise_ampl)."""
    seen = {}
    for r in rows:
        seen[(r["sf"], r["cr"], r["noise_ampl"], r.get("rotate", 0))] = r
    return sorted(
        seen.values(),
        key=lambda r: (r["sf"], r["cr"], r.get("rotate", 0), r["noise_ampl"]),
    )


def tally(rows: list[dict], ours: str, theirs: str) -> tuple:
    """(better, equal, worse) of rows[ours] against rows[theirs], over the
    rows that have both."""
    pairs = [(r[ours], r[theirs]) for r in rows if ours in r and theirs in r]
    return (sum(a > b for a, b in pairs), sum(a == b for a, b in pairs),
            sum(a < b for a, b in pairs))


def merge(outdir: pathlib.Path, names=None) -> list[dict]:
    """Merge outdir/sens_<name>.json (RUNS' names by default) into
    outdir/sensitivity_vs_reference.json and print the tallies."""
    outdir = pathlib.Path(outdir)
    rows = []
    for name in names or [n for n, _ in RUNS]:
        f = outdir / f"sens_{name}.json"
        if not f.exists():
            print(f"missing {f}; skipping", file=sys.stderr)
            continue
        rows.extend(json.loads(f.read_text()))
    merged = dedup(rows)
    out = out_path(outdir / "sensitivity_vs_reference.json")
    out.write_text(json.dumps(merged, indent=1))
    print(f"wrote {out}: {len(merged)} points")
    for what, ours, theirs in (
            ("the reference FSM", "recovered_ours", "recovered_ref"),
            ("lora_tpu (hard)", "recovered_ours", "recovered_jax"),
            ("lora_tpu (soft)", "recovered_soft", "recovered_jax_soft")):
        b, e, w = tally(merged, ours, theirs)
        print(f"against {what}: {b} better, {e} equal, {w} worse")
    for r in merged:
        if "recovered_ref" in r and r["recovered_ours"] < r["recovered_ref"]:
            print("WORSE:", json.dumps(r))
    return merged


def point_specs(rows: list[dict]) -> list[dict]:
    """The points of a rows file: {sf, cr, noise, n, rotate}, the rotation
    at its full value where lora_tpu's rows round it to 4 places."""
    full = float(ROT)
    specs = []
    for r in rows:
        rot = r.get("rotate", 0)
        if rot and rot == round(full, 4):
            rot = full
        specs.append({"sf": r["sf"], "cr": r["cr"], "noise": r["noise_ampl"],
                      "n": r["n"], "rotate": rot})
    return specs


def run_points(path, outdir: pathlib.Path, device) -> list[dict]:
    """Every point of the rows file at `path`, hard and soft ->
    outdir/sens_points.json, then the merge."""
    from . import bench_sensitivity as bs

    rows = []
    for s in point_specs(json.loads(pathlib.Path(path).read_text())):
        row, _ = bs.point(bs.point_cfg(s["sf"], s["cr"]), s["noise"], s["n"],
                          rotate=s["rotate"], soft=True, device=device)
        rows.append(row)
        print(json.dumps(row), flush=True)
    out_path(outdir / "sens_points.json").write_text(
        json.dumps(rows, indent=1))
    return merge(outdir, ["points"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="lora_tpu_torch.tools.run_sensitivity_campaign",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--outdir", default=str(DEFAULT_OUTDIR))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--merge", metavar="DIR", default=None,
                    help="only merge the runs' files in DIR")
    ap.add_argument("--points", metavar="FILE", default=None,
                    help="run exactly the points of a rows file, each at "
                         "its row's n")
    args = ap.parse_args(argv)
    if args.merge is not None:
        merge(pathlib.Path(args.merge))
        return 0
    outdir = pathlib.Path(args.outdir)
    device = pick_device(args.device, "run_sensitivity_campaign")
    if args.points is not None:
        run_points(args.points, outdir, device)
        return 0
    from . import bench_sensitivity as bs

    for name, argv_run in RUNS:
        print(f"=== campaign run {name}", flush=True)
        bs.main([*argv_run, "--device", str(device),
                 "--out", str(outdir / f"sens_{name}.json")])
    merge(outdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
