"""One run of one cell: what BENCHMARK.json and the cell's files say, the
card's checks, the traffic's generator, the per-layer readers, the verdict
and the result line.

Everything that belongs to one cell sits in files of its own, found by the
names in BENCHMARK.json: the configuration's file (its `file`), the traffic
mix `phybench/traffic/<traffic>.json` (whose `generator` names the general
generator in phybench/generators/ that reads it), the limits of the numbers
that decide `correct`, `phybench/limits/<workload>.json`, and one reader
per per-layer metric, `phybench/metrics/<metric>.py`.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys

from . import compare, device
from .reference import lora

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = ROOT / "build" / "phybench"


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic mix,
    limits and metrics."""

    def __init__(self, name: str, root: pathlib.Path = ROOT):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = found[0]
        entry = next(c for c in bench["configs"]
                     if c["name"] == self.workload["config"])
        self.config = json.loads((root / entry["file"]).read_text())
        self.traffic = json.loads(
            (HERE / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.limits = json.loads(
            (HERE / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]

    def override(self, config: dict = None, traffic: dict = None) -> "Cell":
        """Replace entries of the configuration (its `radio` group entry by
        entry) and of the traffic mix: the tests' small sizes."""
        for k, v in (config or {}).items():
            if k == "radio":
                self.config["radio"] = {**self.config["radio"], **v}
            else:
                self.config[k] = v
        self.traffic.update(traffic or {})
        return self

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def radio(self) -> lora.Radio:
        return lora.radio(self.config["radio"])


def reader(metric: str):
    """The per-layer metric's reader, phybench/metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"phybench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the traced window and the shapes of
    what its kernels ran on."""

    trace: object
    shapes: dict


@dataclasses.dataclass
class Run:
    """A run's settings, handed to the traffic's generator."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    dev: object
    t_start: float
    tracer: object


def program_config(radio: lora.Radio):
    """The program's LoRaConfig with the reference Radio's fields."""
    from lora_tpu_torch import LoRaConfig

    return LoRaConfig(**{f.name: getattr(radio, f.name)
                         for f in dataclasses.fields(LoRaConfig)})


def execute(cell: Cell, seed: int, seconds: float, trace: bool, dev,
            t_start: float) -> dict:
    """Drive the cell on `dev` and judge it.  -> the result's fields, and
    `checks` for the lines on standard error."""
    from .trace import Tracer

    tracer = Tracer(trace, str(OUT / f"{cell.name}.trace.json"))
    generator = importlib.import_module(
        f"phybench.generators.{cell.traffic['generator']}")
    run = Run(cell, seed, seconds, trace, dev, t_start, tracer)
    got = generator.run(run)
    correct, checks = compare.judge(got["numbers"], cell.limits)
    res = {"correct": correct, "attempted": got["attempted"],
           "failed": got["failed"]}
    if trace:
        tr = tracer.load()
        ctx = Reading(tr, got["shapes"])
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        res["metrics"] = metrics
        res["trace"] = {"busy_s": tr.busy_s, "window_s": tr.window_s,
                        "breakdown": tr.breakdown()}
    else:
        e2e = dict(got["e2e"], setup_s=got["setup_s"])
        res["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end if m["name"] in e2e}
    res["memory_peak_bytes"] = got["memory_peak_bytes"]
    res["checks"] = checks
    res["notes"] = got.get("notes", {})
    return res


def main(args, t_start: float) -> int:
    try:
        import torch
    except ImportError as e:
        print(f"phybench: torch is missing ({e})", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    try:
        device.require_cards(torch, cell.chips)
    except device.NoCard as e:
        print(f"phybench: {e}", file=sys.stderr)
        return 3
    try:
        import lora_tpu_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"phybench: the program lora_tpu_torch is missing ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    res = execute(cell, args.seed, args.seconds, bool(args.trace), dev,
                  t_start)
    loaded = device.forbidden_modules()
    if loaded:
        print(f"phybench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": cell.chips,
                "memory_peak_bytes": res["memory_peak_bytes"],
                "power_limit": device.power_limit()}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": dev_info}
    if args.trace:
        dev_info["busy_s"] = res["trace"]["busy_s"]
        dev_info["window_s"] = res["trace"]["window_s"]
        line["breakdown"] = res["trace"]["breakdown"]
    line["notes"] = res["notes"]
    line["checks"] = res["checks"]
    for k, v in res["notes"].items():
        print(f"note {k} {v}", file=sys.stderr)
    for k, (v, lim) in res["checks"].items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
