"""The port's tools and examples (lora_tpu_torch.tools, .examples) against
lora_tpu's tools/*.py and examples/*.py on the same numpy inputs, on the
CPU.

The sensitivity bank is rebuilt draw for draw: payloads and delays equal,
the clean TX within 6e-8 a component (the two packages' float32 cos/sin
differ in the last bit), and the noise and rotation bit-equal given the
same clean frames; then both packages decide every frame of one bank
alike.  The e2e wire is within 1 LSB of lora_tpu's construction, and its
three transfer modes give the same float32 input bit for bit.  No test
writes outside its tmp_path or build/, and none calls lora_tpu's merge,
which writes into docs/."""

import hashlib
import importlib.util
import io
import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lora_tpu
from lora_tpu import api as japi
from lora_tpu.ops import cplx as jcplx

from lora_tpu_torch import api as tapi
from lora_tpu_torch.examples import (lora_sdr_relay, lora_simulation,
                                     modulation_explained, rx_rn2483,
                                     wideband_rx)
from lora_tpu_torch.models.decoder import OK
from lora_tpu_torch.tools import (bench_decode, bench_e2e, bench_sensitivity,
                                  bench_soft, bench_stream,
                                  run_sensitivity_campaign)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SAMPLE_ATOL = 6e-8
ROT = float(run_sensitivity_campaign.ROT)
bs = bench_sensitivity


def load_example(name):
    """lora_tpu's examples/<name>.py as a module (they are scripts)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def docs_digest():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO / "docs").iterdir()) if p.is_file()}


# ---- the sensitivity bank and decisions ------------------------------------

def jax_bank(sf, cr, noise, P, seed, rotate):
    """tools/bench_sensitivity.py:116-155 through lora_tpu.api."""
    cfg = lora_tpu.LoRaConfig(sf=sf, cr=cr, ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 4)
    T = lora_tpu.required_samples(cfg)
    rng = np.random.default_rng((seed, sf, int(noise * 1000)))
    payloads = rng.integers(0, 256, (P, 16), np.uint8)
    payloads[:, 0] = np.arange(P)
    delays = rng.integers(0, 2 * cfg.N, P)
    clean = japi.modulate(japi.encode(jnp.asarray(payloads), cfg), cfg)
    bank_re = np.zeros((P, T), np.float32)
    bank_im = np.zeros((P, T), np.float32)
    cre, cim = np.asarray(clean.re), np.asarray(clean.im)
    L = cre.shape[-1]
    for p in range(P):
        d = int(delays[p])
        k = min(L, T - d)
        bank_re[p, d : d + k] = cre[p, :k]
        bank_im[p, d : d + k] = cim[p, :k]
    bank_re += noise * rng.standard_normal((P, T)).astype(np.float32)
    bank_im += noise * rng.standard_normal((P, T)).astype(np.float32)
    if rotate:
        c, s = np.cos(rotate), np.sin(rotate)
        bank_re, bank_im = (
            (c * bank_re - s * bank_im).astype(np.float32),
            (s * bank_re + c * bank_im).astype(np.float32),
        )
    return cfg, payloads, delays, (cre, cim), (bank_re, bank_im)


@pytest.mark.parametrize("sf,cr,noise", [(7, "4/8", 2.0), (8, "4/7", 2.6)])
@pytest.mark.parametrize("rotate", [0.0, ROT], ids=["still", "rotated"])
def test_sensitivity_bank_and_decisions_match_jax(sf, cr, noise, rotate):
    P, seed = 16, bs.SEED
    jcfg, pay, delays, (cre, cim), (jre, jim) = jax_bank(sf, cr, noise, P,
                                                         seed, rotate)
    cfg = bs.point_cfg(sf, cr)
    bank = bs.make_bank(cfg, noise, P, seed, rotate, device="cpu")
    np.testing.assert_array_equal(bank.payloads, pay)
    np.testing.assert_array_equal(bank.delays, delays)
    # the port's TX within the modulators' last-bit difference ...
    clean = tapi.modulate(tapi.encode(pay, cfg, device="cpu"), cfg).numpy()
    np.testing.assert_allclose(clean.real, cre, rtol=0, atol=SAMPLE_ATOL)
    np.testing.assert_allclose(clean.imag, cim, rtol=0, atol=SAMPLE_ATOL)
    # ... and the port's noise and rotation bit-equal on lora_tpu's frames
    rng, _, _ = bs.draw(cfg, noise, P, seed)
    re, im = bs.noisy(rng, cre, cim, delays, jre.shape[1], noise, rotate)
    np.testing.assert_array_equal(re, jre)
    np.testing.assert_array_equal(im, jim)

    # one numpy bank through both packages: every frame decided alike
    one = bs.Bank(pay, delays, jre, jim)
    row, pf = bs.point(cfg, noise, P, rotate=rotate, soft=True, fused="off",
                       device="cpu", bank=one)
    dem = japi.demodulate(jcplx.IQ(jnp.asarray(jre), jnp.asarray(jim)), jcfg,
                          spectra=True)
    found = np.asarray(dem.found)
    hard = bs.recovered(found, japi.extract_payloads(
        japi.decode(dem.symbols.astype(jnp.int32), jcfg)), pay)
    soft = bs.recovered(found, japi.extract_payloads(
        japi.decode_soft(dem.fft_mag2, jcfg)), pay)
    np.testing.assert_array_equal(pf["found"], found)
    np.testing.assert_array_equal(pf["symbols"], np.asarray(dem.symbols))
    np.testing.assert_array_equal(pf["hard"], hard)
    np.testing.assert_array_equal(pf["soft"], soft)
    assert row["recovered_ours"] == hard.sum()
    assert row["recovered_soft"] == soft.sum()
    assert 0 < hard.sum() <= soft.sum()  # a point on the waterfall


def test_sensitivity_row_keys_and_reference_source():
    """A row at a committed point carries lora_tpu's keys and takes the
    reference's and lora_tpu's counts from the committed row; a point with
    no committed row and no oracle has no recovered_ref and says so."""
    assert not bs.ORACLE.exists()
    committed = bs.committed_rows()
    want = next(r for r in committed
                if (r["sf"], r["cr"], r["noise_ampl"], r["n"])
                == (7, "4/8", 1.4, 32) and not r.get("rotate"))
    row, pf = bs.point(bs.point_cfg(7, "4/8"), 1.4, 32, soft=True,
                       device="cpu")
    assert set(row) >= set(want)
    assert row["recovered_ref"] == want["recovered_ref"]
    assert row["fer_ref"] == want["fer_ref"]
    assert row["recovered_jax"] == want["recovered_ours"]
    assert row["recovered_jax_soft"] == want["recovered_soft"]
    assert row["ref_source"] == "docs/sensitivity_vs_reference.json"
    assert row["device"] == "cpu" and pf["found"].shape == (32,)
    alone, _ = bs.point(bs.point_cfg(7, "4/8"), 1.5, 4, device="cpu")
    assert "recovered_ref" not in alone and "recovered_jax" not in alone
    assert alone["ref_source"].startswith("none")


def test_campaign_point_specs_cover_the_committed_matrix():
    rows = bs.committed_rows()
    specs = run_sensitivity_campaign.point_specs(rows)
    assert len(specs) == 60 and sum(s["n"] for s in specs) == 2720
    assert {s["n"] for s in specs} == {32, 128, 256}
    assert [s for s in specs if s["n"] == 256] == [
        {"sf": 7, "cr": "4/5", "noise": 2.3, "n": 256, "rotate": 0}]
    rotated = [s for s in specs if s["rotate"]]
    assert len(rotated) == 10 and all(s["rotate"] == ROT for s in rotated)


def test_campaign_merge_dedup_matches_lora_tpu_rule(tmp_path):
    """tools/run_sensitivity_campaign.py:56-62, reimplemented: one row per
    (sf, cr, noise_ampl, rotate), later runs win, sorted by (sf, cr,
    rotate, noise_ampl)."""
    rng = np.random.default_rng(5)
    files = {}
    for name, _ in run_sensitivity_campaign.RUNS:
        rows = []
        for _ in range(6):
            r = {"sf": int(rng.choice([7, 10])),
                 "cr": str(rng.choice(["4/8", "4/5"])),
                 "noise_ampl": float(rng.choice([1.7, 2.0, 4.8])),
                 "n": 32, "recovered_ours": int(rng.integers(0, 33)),
                 "recovered_ref": int(rng.integers(0, 33)), "run": name}
            if rng.random() < 0.3:
                r["rotate"] = 2.5447
            rows.append(r)
        files[name] = rows
        (tmp_path / f"sens_{name}.json").write_text(json.dumps(rows))
    seen = {}
    for name, _ in run_sensitivity_campaign.RUNS:
        for r in files[name]:
            seen[(r["sf"], r["cr"], r["noise_ampl"], r.get("rotate", 0))] = r
    want = sorted(seen.values(), key=lambda r: (
        r["sf"], r["cr"], r.get("rotate", 0), r["noise_ampl"]))
    before = docs_digest()
    got = run_sensitivity_campaign.merge(tmp_path)
    assert got == want
    assert json.loads(
        (tmp_path / "sensitivity_vs_reference.json").read_text()) == want
    assert docs_digest() == before


def test_campaign_points_run_on_cpu_leaves_docs_alone(tmp_path, capsys):
    pts = [{"sf": 7, "cr": "4/8", "noise_ampl": 1.4, "n": 32},
           {"sf": 7, "cr": "4/8", "noise_ampl": 2.0, "n": 8,
            "rotate": 2.5447}]
    src = tmp_path / "points.json"
    src.write_text(json.dumps(pts))
    before = docs_digest()
    out = tmp_path / "out"
    assert run_sensitivity_campaign.main(
        ["--points", str(src), "--outdir", str(out), "--device", "cpu"]) == 0
    assert docs_digest() == before
    rows = json.loads((out / "sensitivity_vs_reference.json").read_text())
    assert [(r["noise_ampl"], r["n"], r.get("rotate", 0)) for r in rows] == [
        (1.4, 32, 0), (2.0, 8, 2.5447)]
    assert rows[0]["ref_source"] == "docs/sensitivity_vs_reference.json"
    assert "against the reference FSM: " in capsys.readouterr().out
    with pytest.raises(ValueError, match="docs/"):
        bs.main(["--sf", "7", "--noise", "2.0", "--packets", "2",
                 "--device", "cpu", "--out",
                 str(REPO / "docs" / "sensitivity_vs_reference.json")])
    assert docs_digest() == before


# ---- bench_e2e ---------------------------------------------------------------

def jax_wire(sf, slab, payload_len, rng):
    """tools/bench_e2e.py:96-120 through lora_tpu.api."""
    cfg = lora_tpu.LoRaConfig(sf=sf, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(payload_len) + 4)
    T = lora_tpu.required_samples(cfg)
    payload = rng.integers(0, 256, (slab, payload_len), dtype=np.uint8)
    iq = japi.modulate(japi.encode(jnp.asarray(payload), cfg), cfg)
    re = np.asarray(iq.re)[:, :T]
    im = np.asarray(iq.im)[:, :T]
    if re.shape[1] < T:
        re = np.pad(re, ((0, 0), (0, T - re.shape[1])))
        im = np.pad(im, ((0, 0), (0, T - im.shape[1])))
    re = re + 0.05 * rng.standard_normal(re.shape, dtype=np.float32)
    im = im + 0.05 * rng.standard_normal(im.shape, dtype=np.float32)
    wire = np.empty((slab, 2 * T), np.int16)
    wire[:, 0::2] = np.clip(re * 8192.0, -32768, 32767).astype(np.int16)
    wire[:, 1::2] = np.clip(im * 8192.0, -32768, 32767).astype(np.int16)
    return cfg, wire


def test_e2e_wire_and_modes_match_jax():
    jcfg, jwire = jax_wire(8, 4, 8, np.random.default_rng(0))
    g = bench_e2e.make_group(8, 4, 8, np.random.default_rng(0), "cpu")
    assert g["wire"].shape == jwire.shape
    assert np.abs(g["wire"].astype(np.int32) - jwire).max() <= 1
    inputs, outs = {}, {}
    for mode in bench_e2e.MODES:
        shape, dtype = bench_e2e.block_spec(g, mode)
        buf = torch.empty(shape, dtype=dtype)
        bench_e2e.fill(g, mode, buf)
        inputs[mode] = bench_e2e.device_input(buf, mode)
        outs[mode] = [t.numpy() for t in bench_e2e.step(g, buf, mode)]
    x = inputs["planar"]
    assert x.dtype == torch.complex64 and x.shape == (4, g["T"])
    for mode in ("host-convert", "interleaved"):
        torch.testing.assert_close(inputs[mode], x, rtol=0, atol=0)
    dem = japi.demodulate(jcplx.IQ(jnp.asarray(x.real.numpy()),
                                   jnp.asarray(x.imag.numpy())), jcfg)
    dec = japi.decode(dem.symbols.astype(jnp.int32), jcfg)
    want = [np.asarray(dem.found), np.asarray(dec.status),
            np.asarray(dec.length)]
    for mode, got in outs.items():
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert want[0].all() and (want[1] == OK).all()


@pytest.mark.parametrize("flags", [[], ["--host-convert"], ["--interleaved"],
                                   ["--mixed-sf"]],
                         ids=["planar", "host-convert", "interleaved",
                              "mixed-sf"])
def test_e2e_main_on_cpu_decodes_every_frame(flags, capsys):
    assert bench_e2e.main(["--device", "cpu", "--channels", "8", "--slab",
                           "4", *flags]) == 0
    rec, comp = [json.loads(ln) for ln in
                 capsys.readouterr().out.strip().splitlines()[-2:]]
    assert rec["bench"] == "config5_e2e"
    assert rec["frames_found"] == rec["frames_decoded_ok"] == rec["of"] == 8
    assert rec["device"] == "cpu" and rec["slabs"] == 2
    assert set(rec) >= {"channels", "slab", "slabs", "T", "mode",
                        "measured_Msamp_s", "measured_rt_channels_500kHz",
                        "wall_s", "convert_host_s", "per_slab_s", "rss_mb",
                        "note"}
    assert ("groups" in rec) == ("--mixed-sf" in flags)
    assert comp["bench"] == "config5_e2e_compute"
    assert comp["link_bytes_per_sample"] == (8 if flags == ["--host-convert"]
                                             else 4)
    assert comp["h2d_GBs_measured"] == "not measured"  # no link on the CPU


# ---- the soft, decode and stream benches ------------------------------------

def test_bench_soft_and_decode_records(capsys):
    assert bench_soft.main(["--device", "cpu", "--reps", "2"]) == 0
    assert bench_decode.main(["--device", "cpu", "--reps", "2"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    soft, dec = recs[:3], recs[3:]
    # lora_tpu's keys, then the spread of the timed calls
    assert set(soft[0]) >= {"path", "ms", "Gsamp/s", "min_ms", "max_ms"}
    assert set(soft[1]) >= {"path", "ms", "Gsamp/s", "soft_vs_hard"}
    assert set(soft[2]) >= {"path", "ms", "Gsamp/s", "fused_speedup"}
    assert [r["stage"] for r in dec] == ["demod only", "demod+decode",
                                         "decode only"]
    assert set(dec[2]) >= {"ms", "us_per_frame", "marginal_decode_ms"}
    for r in recs:
        assert r["min_ms"] <= r["ms"] <= r["max_ms"] and r["calls"] == 2
        assert r["device"] == "cpu" and (r["B"], r["sf"]) == (4, 7)


@pytest.mark.parametrize("mod", [bench_soft, bench_decode],
                         ids=["soft", "decode"])
def test_bench_gate_raises_on_a_corrupted_payload(mod, monkeypatch):
    bank = mod.bench_bank

    def corrupted(*a):
        cfg, x, pay = bank(*a)
        pay = pay.copy()
        pay[2, 5] ^= 0x40
        return cfg, x, pay

    monkeypatch.setattr(mod, "bench_bank", corrupted)
    with pytest.raises(AssertionError, match="1 of 4 bench frames"):
        mod.measure(4, 7, torch.device("cpu"), 2)


def test_bench_stream_lines_and_frames(capsys):
    rec = bench_stream.bench_ingest(B=4, chunk=1024, total=1 << 15)
    recs = bench_stream.bench_pump(4, 7, torch.device("cpu"))
    out = capsys.readouterr().out.splitlines()
    # lora_tpu's lines (tools/bench_stream.py:62-69, 150-156)
    assert re.fullmatch(r"ring ingest : +[\d.]+ Msamp/s  \( *[\d.]+ ms for "
                        r"4x[\d.]+M samples\)", out[0])
    assert re.fullmatch(r"concatenate : +[\d.]+ Msamp/s  \( *[\d.]+ ms\)   "
                        r"-> ring is [\d.]+x", out[1])
    assert rec["ring_Msamp_s"] > 0 and rec["concatenate_Msamp_s"] > 0
    assert len(out) == 6 and len(recs) == 4
    for line, r in zip(out[2:], recs):
        assert re.fullmatch(r"(wire cf32|planar IQ) (serial feed/run |pump "
                            r"\(pipelined\)) : +[\d.]+ Msamp/s  \(24 frames, "
                            r" *[\d.]+ ms, [\d.]+x vs serial\) \[cpu\]", line)
        assert r["frames"] == 24
        t = sorted((f.channel, f.t_start) for f in r["frame_list"])
        assert t == sorted((f.channel, f.t_start)
                           for f in recs[0]["frame_list"])


# ---- the examples -------------------------------------------------------------

RX_LINE = re.compile(r"RX: ch +(\d+)  t_sync +(\d+)  snr +\S+ dB  payload "
                     r"(.*)")


def test_wideband_rx_matches_jax(capsys):
    assert wideband_rx.main(["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert load_example("wideband_rx").main() == 0
    theirs = capsys.readouterr().out
    got = [RX_LINE.fullmatch(ln).groups() for ln in ours.splitlines()
           if ln.startswith("RX:")]
    assert got and got == [RX_LINE.fullmatch(ln).groups()
                           for ln in theirs.splitlines()
                           if ln.startswith("RX:")]
    assert ours.splitlines()[-1] == theirs.splitlines()[-1] == \
        "byte-exact: True"


def test_lora_simulation_piped_matches_jax(capsys, monkeypatch):
    lines = ["/sf 7", "/noise 0.5", "hello world!", "/cr 4/7", "/show",
             "/sf 13", "second frame", "/bogus"]
    assert lora_simulation.main(["--device", "cpu"], lines) == 0
    ours = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    assert load_example("lora_simulation").main() == 0
    theirs = capsys.readouterr().out.splitlines()
    rx = lambda out: [ln.split("   snr=")[0] for ln in out if "  rx: " in ln]
    assert rx(ours) == rx(theirs) == ["  rx: hello world!",
                                      "  rx: second frame"]
    ctl = lambda out: [ln for ln in out if ln.startswith("[")]
    assert ctl(ours) == ctl(theirs)


def test_modulation_explained_matches_jax(capsys, tmp_path, monkeypatch):
    png = tmp_path / "m.png"
    assert modulation_explained.main(["--device", "cpu", "--plot", "--out",
                                      str(png)]) == 0
    ours = capsys.readouterr().out.splitlines()
    assert png.stat().st_size > 0
    monkeypatch.setattr(sys, "argv", ["modulation_explained.py"])
    assert load_example("modulation_explained").main() == 0
    theirs = capsys.readouterr().out.splitlines()
    assert ours[:4] == theirs[:4]
    # lora_tpu's list prints numpy scalars: np.int32(37)
    values = lambda line: re.sub(r"np\.int32\((\d+)\)", r"\1",
                                 line.split("->")[1]).strip()
    assert values(ours[4]) == values(theirs[4]) == "[0, 37, 200, 255]"


@pytest.mark.parametrize("mod", [lora_sdr_relay, rx_rn2483],
                         ids=["lora_sdr_relay", "rx_rn2483"])
def test_radio_examples_raise_without_soapysdr(mod, monkeypatch):
    monkeypatch.setitem(sys.modules, "SoapySDR", None)
    with pytest.raises(RuntimeError, match="SoapySDR"):
        mod.main(["--device", "cpu"])


@pytest.mark.parametrize("main", [
    bench_sensitivity.main, run_sensitivity_campaign.main, bench_e2e.main,
    bench_soft.main, bench_decode.main, bench_stream.main, wideband_rx.main,
    lora_simulation.main, modulation_explained.main, lora_sdr_relay.main,
    rx_rn2483.main], ids=lambda f: f.__module__.rsplit(".", 1)[1])
def test_twins_refuse_without_a_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([])
