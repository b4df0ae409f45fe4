"""The cell us915-wideband-128 on the CPU: its files, its generator
(phybench/generators/spaced.py), its reference resampler, its verdict with
faults planted in the timed path, its control, and the resample_roofline
reader.  Tests that need the card carry the `cuda` marker and skip here."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from phybench import compare, harness, inputs
from phybench.generators import bank, spaced
from phybench.reference import lora
from phybench.reference import resample as rres
from phybench.trace import Trace
from test_phybench_harness import _ev, _plant

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "us915-wideband-128"
CPU = torch.device("cpu")
# SF7 with 24-byte payloads: 10,240 LoRa samples, 16,384 at the slot rate
SMALL = {"streams": 2, "K": 8, "radio": {"sf": 7, "payload_bytes": 24}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _small():
    return harness.Cell(CELL).override(
        config=SMALL, traffic={"banks": 2, "warmup_s": 0.0})


def test_the_cells_files_are_found_by_name():
    c = harness.Cell(CELL)
    assert c.traffic["generator"] == "spaced" and c.chips == 1
    assert c.limits == {"decision_diff": 0, "payload_diff": 0,
                        "estimates_parted": 0.002}
    assert {m["name"] for m in c.end_to_end} == {"msamples_per_s",
                                                 "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "detect_roofline", "channelize_roofline", "idle_share.bank",
        "readback_ms", "device_ms.demodulate", "device_ms.decode",
        "host_ms.replay", "idle_share.program", "resample_roofline"}
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]))
    entry = next(x for x in BENCH["configs"]
                 if x["name"] == c.workload["config"])
    assert c.config["reduced"] == entry["reduced"]
    assert all(k in c.config for k in entry["reduced"])
    cfg = c.radio()
    assert (cfg.sf, cfg.cr, cfg.preamble_symbols, cfg.sync) == (9, "4/5", 8,
                                                                0x34)
    # a frame is 48 symbols; the demodulator's 40,960 samples at 125 kHz
    # are 65,536 at the 200-kHz slot rate
    assert cfg.num_symbols(32) == 48 and lora.required_samples(cfg) == 40960
    assert lora.required_samples(cfg) * spaced.ratio_of(c.config) == 65536
    assert c.config["slot_spacing_hz"] / c.config["bandwidth_hz"] == 1.6


def test_the_blocks_are_made_from_the_seed():
    c = _small()
    cfg = c.radio()
    imp = c.traffic["impair"]
    seed = 2**31 + 4321
    make = lambda s: spaced.wideband(cfg, 2, 8, 8, spaced.ratio_of(c.config),
                                     24, imp, inputs.generator(s, CPU), CPU)
    a, b, d = make(seed), make(seed), make(seed + 1)
    assert torch.equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not torch.equal(a[0], d[0])
    assert a[0].shape == (2, 8 * 16384) and a[1].shape == (2, 8, 24)


@pytest.mark.parametrize("ratio", [1.6, 0.625])
def test_the_reference_resampler_is_the_programs_plain_route(ratio):
    from lora_tpu_torch.ops import resample as trs

    g = torch.Generator().manual_seed(5)
    x = torch.randn((3, 4000), dtype=torch.complex64, generator=g)
    M = int(4000 / ratio)  # the last outputs' taps clamped at the end
    assert torch.equal(rres.resample(x, ratio, out_len=M),
                       trs.resample(x, ratio, out_len=M))


def test_a_small_run_on_the_cpu_is_correct():
    res = harness.execute(_small(), 2**31 + 99, 0.5, False, CPU, 0.0)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0, res["notes"]
    assert set(res["metrics"]) == {"msamples_per_s", "setup_s"}


def test_the_control_fails_at_a_small_size():
    from phybench import calibrate

    c = _small()
    with spaced.in_place_of_bank():
        got = calibrate.control_numbers(c, 5, 0.5, CPU)
    assert bank.Banks is not spaced.Banks
    assert not compare.judge(got, c.limits)[0], got


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size(card):
    from phybench import calibrate

    c = harness.Cell(CELL)
    with spaced.in_place_of_bank():
        got = calibrate.control_numbers(c, 2**31 + 5, 1.0, card)
    assert not compare.judge(got, c.limits)[0], got


@pytest.mark.parametrize("fault", ["odd_channels", "altered_symbol",
                                   "altered_payload"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, CELL, fault)
    res = harness.execute(_small(), 2**31 + 99, 0.5, False, CPU, 0.0)
    assert res["correct"] is False, res["checks"]


def test_resample_roofline_reads_kernel_rs_launches():
    read = harness.reader("resample_roofline")
    shape = (8192, 65536, 40960, 14)
    ev = [_ev("phybench.window", "user_annotation", 0, 1000),
          _ev("void lora::resample_kernel(float2 const*, long long)",
              "kernel", 10, 300),
          _ev("void lora::resample_kernel(float2 const*, long long)",
              "kernel", 400, 500),
          _ev("void lora::channelize_fft_kernel<6, 8>()", "kernel", 320, 60)]
    got = read(harness.Reading(Trace(ev), {"resample": shape}))
    # read once and written once: 8,192 x (65,536 + 40,960) x 8 bytes
    b = 8192 * (65536 + 40960) * 8 / 3.35e12
    assert got == pytest.approx(100 * 2 * b / 800e-6)
    assert read(harness.Reading(Trace(ev[:1] + ev[3:]),
                                {"resample": shape})) is None
    assert read(harness.Reading(Trace(ev), {})) is None
