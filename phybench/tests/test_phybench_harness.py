"""The benchmark's harness on the CPU: its files, generators, reference,
metric readers and verdicts.  Tests that need the card carry the `cuda`
marker and skip here (the `card` fixture decides)."""

from __future__ import annotations

import ast
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from phybench import compare, harness, inputs, roofline
from phybench.reference import lora, rx
from phybench.trace import Trace

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"radio": {"sf": 7, "payload_bytes": 8}, "channels": 8}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


# -- BENCHMARK.json and the cells' files -------------------------------------

def test_names_units_and_keys_are_well_formed():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[kind]}) == len(BENCH[kind])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cells_files_are_found_by_name(cell):
    c = harness.Cell(cell)
    assert c.traffic["generator"] == "bank"
    assert (ROOT / "phybench" / "generators" / f"{c.traffic['generator']}.py"
            ).exists()
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert c.per_layer and any(m["name"] != "setup_s"
                               for m in c.end_to_end)
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]))
    entry = next(x for x in BENCH["configs"] if x["name"] == c.workload[
        "config"])
    assert entry["file"].startswith("phybench/")
    assert c.config["reduced"] == entry["reduced"]


def _imports(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", "") == "__import__":
            tops.add(str(getattr(node.args[0], "value", "")).split(".")[0])
    return tops


def test_no_jax_anywhere_and_no_program_in_the_reference():
    files = sorted((ROOT / "phybench").rglob("*.py"))
    assert files
    for f in files:
        got = _imports(f)
        assert not got & {"jax", "jaxlib", "flax", "lora_tpu"}, (f, got)
        if "reference" in f.parts:
            assert "lora_tpu_torch" not in got, f


# -- generators and the reference --------------------------------------------

def test_generators_are_deterministic_by_seed():
    cfg = lora.radio({"sf": 7, "cr": "4/8", "ampl": 1.0, "payload_bytes": 8,
                      "mtu_extra": 2})
    imp = {"max_delay_symbols": 2, "cfo_int": 2, "cfo_frac": 0.4,
           "sigma": 0.1}
    seed = 2**31 + 12345
    a = inputs.bank(cfg, 4, 8, imp, inputs.generator(seed, CPU), CPU)
    b = inputs.bank(cfg, 4, 8, imp, inputs.generator(seed, CPU), CPU)
    c = inputs.bank(cfg, 4, 8, imp, inputs.generator(seed + 1, CPU), CPU)
    assert torch.equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    w1 = inputs.wideband(cfg, 2, 8, 8, 8, imp,
                         inputs.generator(seed, CPU), CPU)
    w2 = inputs.wideband(cfg, 2, 8, 8, 8, imp,
                         inputs.generator(seed, CPU), CPU)
    assert torch.equal(w1[0], w2[0]) and w1[1].shape == (2, 8, 8)


def test_reference_decodes_the_frozen_transmitters_frames_byte_exact():
    cfg = lora.radio({"sf": 7, "cr": "4/8", "ampl": 1.0, "payload_bytes": 16,
                      "mtu_extra": 2})
    imp = {"max_delay_symbols": 3, "cfo_int": 2, "cfo_frac": 0.4,
           "sigma": 0.1}
    bank, sent = inputs.bank(cfg, 6, 16, imp, inputs.generator(7, CPU), CPU)
    d = rx.demodulate(bank, cfg)
    dec = rx.decode(d["symbols"], cfg)
    assert bool(d["found"].all()) and bool((dec["status"] == 0).all())
    got = dec["data"].numpy()[:, 3 : 3 + 16]
    assert np.array_equal(got, sent)


def test_reference_is_the_programs_plain_route():
    """On the CPU the program runs its plain versions, which the reference
    copies: the same fields, bit for bit."""
    from lora_tpu_torch import api

    cfg = lora.radio({"sf": 8, "cr": "4/5", "ampl": 1.0, "payload_bytes": 12,
                      "mtu_extra": 4})
    imp = {"max_delay_symbols": 3, "cfo_int": 2, "cfo_frac": 0.4,
           "sigma": 0.1}
    bank, _ = inputs.bank(cfg, 4, 12, imp, inputs.generator(9, CPU), CPU)
    pcfg = harness.program_config(cfg)
    ref = rx.demodulate(bank, cfg)
    dem = api.demodulate(bank, pcfg, fused="off")
    for k in compare.DEMOD:
        assert torch.equal(ref[k], getattr(dem, k)), k
    dec = api.decode(dem.symbols, pcfg)
    rdec = rx.decode(ref["symbols"], cfg)
    for k in compare.DECODE:
        assert torch.equal(rdec[k], getattr(dec, k)), k


# -- rooflines and readers ---------------------------------------------------

def test_roofline_bytes_follow_the_shapes():
    # the flagship bank read once: 4096 x 98,304 complex64 = 3.22 GB
    t = roofline.detect(4096, 98304, 1024)
    assert t == pytest.approx((4096 * 98304 * 8 + 3 * 4096 * 96 * 4)
                              / 3.35e12)
    assert 3.22e9 < t * 3.35e12 < 3.23e9
    # config 3: 1.34 GB read, 1.34 GB written
    d = roofline.channelize(256, 655360, 64, 8)
    assert d * 3.35e12 == pytest.approx(2 * 256 * 655360 * 8)
    assert roofline.detect(8192, 98304, 1024) == pytest.approx(2 * t)


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def synthetic_trace() -> Trace:
    """A window of 1000 us: two calls, each a demodulate span launching
    kernel A (100 us) and the payload kernel (50 us), then a decode span
    whose graph launch runs two kernels (20 us each) and a copy (10 us),
    then a read-back span whose two copies to the host take 10 and 5 us;
    an absorbing spin kernel before the window."""
    ev = [_ev("spin_kernel", "kernel", -50, 10, tid=7),
          _ev("phybench.window", "user_annotation", 0, 1000)]
    for i, t in enumerate((0, 500)):
        c = 10 * i
        ev += [_ev("phybench.demodulate", "user_annotation", t, 40),
               _ev("cudaGraphLaunch", "cuda_runtime", t + 5, 10, corr=c),
               _ev("void lora::detect_kernel<10, false>(float2 const*)",
                   "kernel", t + 20, 100, tid=7, corr=c),
               _ev("void lora::payload_kernel<10, false>()", "kernel",
                   t + 120, 50, tid=7, corr=c),
               _ev("phybench.decode", "user_annotation", t + 45, 30),
               _ev("cudaGraphLaunch", "cuda_runtime", t + 50, 10,
                   corr=c + 1),
               _ev("cudaMemcpyAsync", "cuda_runtime", t + 62, 5,
                   corr=c + 2),
               _ev("void at::native::k1()", "kernel", t + 170, 20, tid=7,
                   corr=c + 1),
               _ev("void at::native::k2()", "kernel", t + 190, 20, tid=7,
                   corr=c + 1),
               _ev("Memcpy DtoD", "gpu_memcpy", t + 210, 10, tid=7,
                   corr=c + 2),
               _ev("phybench.readback", "user_annotation", t + 80, 300),
               _ev("cudaMemcpyAsync", "cuda_runtime", t + 85, 5,
                   corr=c + 3),
               _ev("cudaMemcpyAsync", "cuda_runtime", t + 91, 5,
                   corr=c + 4),
               _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", t + 220,
                   10, tid=7, corr=c + 3),
               _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", t + 232,
                   5, tid=7, corr=c + 4)]
    return Trace(ev)


def test_trace_reductions():
    tr = synthetic_trace()
    assert tr.window_s == pytest.approx(1e-3)
    # busy: 215 us a call (20..230, 232..237)
    assert tr.busy_s == pytest.approx(430e-6)
    assert tr.idle_share() == pytest.approx(57.0)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["lora::detect_kernel<10, false>",
                                   pytest.approx(200e-6)]
    assert bd["idle_gaps"][0][1] == pytest.approx(283e-6)  # 237..520
    assert bd["idle_gaps"][0][0] == "phybench.readback"


def _read(metric, shapes=None, tr=None):
    ctx = harness.Reading(tr or synthetic_trace(), shapes or {})
    return harness.reader(metric)(ctx)


def test_metric_readers_read_a_synthetic_trace():
    t = roofline.detect(4096, 98304, 1024)
    assert _read("detect_roofline", {"detect": (4096, 98304, 1024)}) == \
        pytest.approx(100 * 2 * t / 200e-6)
    assert _read("detect_roofline") is None  # nothing to read: no shape
    assert _read("channelize_roofline",
                 {"channelize": (256, 655360, 64, 8)}) is None  # no kernel
    assert _read("stage_ms.decode") == pytest.approx(0.05)
    assert _read("idle_share.bank") == pytest.approx(57.0)
    assert _read("readback_ms") == pytest.approx(0.015)
    ev = [_ev("phybench.window", "user_annotation", 0, 1000),
          _ev("void lora::channelize_fft_kernel<6, 8>()", "kernel", 10, 900)]
    got = _read("channelize_roofline", {"channelize": (256, 655360, 64, 8)},
                tr=Trace(ev))
    assert got == pytest.approx(100 * roofline.channelize(
        256, 655360, 64, 8) / 900e-6)


# -- verdicts -----------------------------------------------------------------

def test_judge_fails_a_number_over_its_limit_or_without_one():
    assert compare.judge({"a": 0, "b": 1.0}, {"a": 0, "b": 2.0})[0]
    assert not compare.judge({"a": 1}, {"a": 0})[0]
    assert not compare.judge({"a": 0}, {"a": 0, "b": 1.0})[0]


def _small(cell):
    c = harness.Cell(cell)
    if c.traffic["entry"] == "demodulate":
        return c.override(config=SMALL,
                          traffic={"banks": 2, "warmup_s": 0.0})
    return c.override(config={"streams": 2, "K": 8},
                      traffic={"banks": 2, "warmup_s": 0.0})


@pytest.mark.parametrize("cell", ["sf10-bank-4096", "meshtastic-wideband-256"])
def test_a_small_run_on_the_cpu_is_correct(cell):
    res = harness.execute(_small(cell), 2**31 + 99, 0.5, False, CPU, 0.0)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0, res["notes"]
    assert set(res["metrics"]) == {"msamples_per_s", "setup_s"}


@pytest.mark.parametrize("cell", ["sf10-bank-4096", "meshtastic-wideband-256"])
def test_the_control_fails_at_a_small_size(cell):
    from phybench import calibrate

    c = _small(cell)
    got = calibrate.control_numbers(c, 5, 0.5, CPU)
    assert not compare.judge(got, c.limits)[0], got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sf10-bank-4096", "meshtastic-wideband-256"])
def test_the_control_fails_at_the_cells_size(card, cell):
    from phybench import calibrate

    c = harness.Cell(cell)
    got = calibrate.control_numbers(c, 2**31 + 5, 1.0, card)
    assert not compare.judge(got, c.limits)[0], got


# -- faults planted in the timed path ----------------------------------------

def _doubled(res):
    """A DemodResult whose second half repeats its first half."""
    import dataclasses

    return dataclasses.replace(res, **{
        f.name: torch.cat([getattr(res, f.name)] * 2)
        for f in dataclasses.fields(res) if getattr(res, f.name) is not None})


def _plant(monkeypatch, cell, fault):
    import dataclasses

    from lora_tpu_torch import api

    name = ("demodulate" if cell == "sf10-bank-4096"
            else "channelized_demodulate")
    demod, decode = getattr(api, name), api.decode

    if fault == "half_batch":
        # half of the batch left out: the first half's results stand in
        # for the second's
        def broken(x, *a, **k):
            out = demod(x[: x.shape[0] // 2], *a, **k)
            if isinstance(out, tuple):
                return (_doubled(out[0]), out[1])
            return _doubled(out)
        monkeypatch.setattr(api, name, broken)
    elif fault == "altered_symbol":
        def broken(x, *a, **k):
            out = demod(x, *a, **k)
            res = out[0] if isinstance(out, tuple) else out
            sym = res.symbols.clone()
            sym.view(-1, sym.shape[-1])[0, 5] ^= 1
            res = dataclasses.replace(res, symbols=sym)
            return (res, out[1]) if isinstance(out, tuple) else res
        monkeypatch.setattr(api, name, broken)
    elif fault == "odd_channels":
        # the odd channels left out: their results zero, none found
        def broken(x, *a, **k):
            out = demod(x, *a, **k)
            res = out[0] if isinstance(out, tuple) else out

            def cut(t):
                t = t.clone()
                (t[:, 1::2] if isinstance(out, tuple) else t[1::2]).zero_()
                return t
            res = dataclasses.replace(res, **{
                f.name: cut(getattr(res, f.name))
                for f in dataclasses.fields(res)
                if getattr(res, f.name) is not None})
            return (res, out[1]) if isinstance(out, tuple) else res
        monkeypatch.setattr(api, name, broken)
    elif fault == "altered_payload":
        def broken(sym, *a, **k):
            res = decode(sym, *a, **k)
            data = res.data.clone()
            data.view(-1, data.shape[-1])[0, 4] ^= 0x40
            return dataclasses.replace(res, data=data)
        monkeypatch.setattr(api, "decode", broken)


@pytest.mark.parametrize("fault", ["half_batch", "odd_channels",
                                   "altered_symbol", "altered_payload"])
@pytest.mark.parametrize("cell", ["sf10-bank-4096", "meshtastic-wideband-256"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    _plant(monkeypatch, cell, fault)
    res = harness.execute(_small(cell), 2**31 + 99, 0.5, False, CPU, 0.0)
    assert res["correct"] is False, res["checks"]
