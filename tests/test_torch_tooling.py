"""The port's last modules against lora_tpu on the same numpy inputs: the
chirp helpers (ops/chirp.chirp_phase_turns, gen_chirp), the TX event
offsets (models/modulator.tx_frame_events), the tracing hooks
(utils/trace.profile, frame_events) and the headline benchmark
(benchmarks.py).

Phases in turns are bit-equal (an exact integer over a power of two);
chirp samples within 6e-8, one unit in the last place below 1.0 (the two
libraries' float32 cos/sin differ in the last bit); event offsets equal;
frame records' integers equal, dB values and fine CFO within 1e-3 (the
demodulators' float32 FFTs of another order)."""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import lora_tpu
from lora_tpu import api as japi
from lora_tpu.models import modulator as jmod
from lora_tpu.ops import chirp as jchirp
from lora_tpu.ops import cplx as jcplx
from lora_tpu.utils import trace as jtrace

from lora_tpu_torch import api as tapi
from lora_tpu_torch import benchmarks
from lora_tpu_torch.models import modulator as tmod
from lora_tpu_torch.ops import chirp
from lora_tpu_torch.utils import trace

torch.set_num_threads(1)

SAMPLE_ATOL = 6e-8
FIELD_TOL = 1e-3


def assert_samples_close(got, want):
    """complex64 samples, re and im each within SAMPLE_ATOL."""
    np.testing.assert_allclose(torch.view_as_real(got).numpy(),
                               np.stack([want.real, want.imag], -1), rtol=0,
                               atol=SAMPLE_ATOL)


@pytest.mark.parametrize("N,ovs", [(128, 1), (1024, 1), (4096, 1), (16, 4),
                                   (256, 8)])
def test_chirp_phase_turns_bit_equal(N, ovs):
    rng = np.random.default_rng(N * ovs)
    syms = np.concatenate([[0, 1, N - 1], rng.integers(0, N, 4)])
    for down in (False, True):
        for n_samples in (N * ovs, N * ovs // 4):
            turns, carry = chirp.chirp_phase_turns(syms, n_samples, N, ovs,
                                                   down, device="cpu")
            jturns, jcarry = jax.vmap(lambda s: jchirp.chirp_phase_turns(
                s, n_samples, N, ovs, down))(jnp.asarray(syms))
            assert turns.dtype == torch.float32 and carry.dtype == torch.int32
            np.testing.assert_array_equal(turns.numpy(), np.asarray(jturns))
            np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry))


@pytest.mark.parametrize("s,N,ovs,n_samples,down,phase0", [
    (0, 128, 1, None, False, 0.0), (100, 1024, 1, None, False, 0.3),
    (7, 256, 2, None, True, 0.125), (3, 64, 1, 16, True, 0.9),
    (4095, 4096, 1, None, False, 0.5)])
def test_gen_chirp_matches_jax(s, N, ovs, n_samples, down, phase0):
    iq, end = chirp.gen_chirp(s, N, ovs, n_samples, down, ampl=0.8,
                              phase0_turns=phase0, device="cpu")
    jiq, jend = jchirp.gen_chirp(s, N, ovs, n_samples, down, ampl=0.8,
                                 phase0_turns=phase0)
    want = jcplx.to_complex(jiq)
    assert iq.dtype == torch.complex64 and iq.shape == want.shape
    assert_samples_close(iq, want)
    assert end.dtype == torch.float32
    assert end.item() == float(jend)


def test_gen_chirp_phase_continuity_matches_jax():
    """Two symbols chained by the end phase, as tests/test_chirp_detect.py
    chains them; per-symbol phases over a batch of symbols."""
    iq1, end1 = chirp.gen_chirp(3, 64, device="cpu")
    iq2, end2 = chirp.gen_chirp(9, 64, phase0_turns=end1, device="cpu")
    j1, jend1 = jchirp.gen_chirp(3, 64)
    j2, jend2 = jchirp.gen_chirp(9, 64, phase0_turns=jend1)
    assert_samples_close(iq2, jcplx.to_complex(j2))
    assert end2.item() == float(jend2)
    both, ends = chirp.gen_chirp(torch.tensor([3, 9]), 64,
                                 phase0_turns=torch.stack([torch.tensor(0.0),
                                                           end1]))
    torch.testing.assert_close(both, torch.stack([iq1, iq2]), rtol=0, atol=0)
    torch.testing.assert_close(ends, torch.stack([end1, end2]), rtol=0,
                               atol=0)


@pytest.mark.parametrize("sf,pre,padding,n_sym", [(7, 10, 1, 12),
                                                  (10, 8, 2, 40),
                                                  (12, 6, 1, 3)])
def test_tx_frame_events_match_jax(sf, pre, padding, n_sym):
    fields = dict(sf=sf, cr="4/8", preamble_symbols=pre, padding=padding)
    got = tmod.tx_frame_events(lora_tpu.LoRaConfig(**fields), n_sym)
    import lora_tpu_torch

    assert got == jmod.tx_frame_events(lora_tpu.LoRaConfig(**fields), n_sym)
    assert got == tmod.tx_frame_events(lora_tpu_torch.LoRaConfig(**fields),
                                       n_sym)


def test_tx_frame_events_match_the_ports_demod_timing():
    """tests/test_aux.py's check on the port: the offsets agree with the
    modulated frame's length and with the port's demodulator on a
    zero-delay frame."""
    from lora_tpu_torch import LoRaConfig

    rng = np.random.default_rng(0x10A4)
    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
    p = rng.integers(0, 256, (1, 4)).astype(np.uint8)
    syms = tapi.encode(p, cfg, device="cpu")
    iq = tapi.modulate(syms, cfg)
    ev = tmod.tx_frame_events(cfg, syms.shape[-1])
    assert ev["t_pad_end"] == iq.shape[-1] == cfg.frame_samples(syms.shape[-1])
    dem = tapi.demodulate(iq, cfg)
    assert bool(dem.found[0])
    assert int(dem.t_sync[0]) == ev["t_sync"]
    assert int(dem.consumed[0]) == ev["t_data"] + int(dem.count[0]) * cfg.N


def test_frame_events_match_jax():
    """The same bank (frames on channels 0, 2, 3 at several delays, channel
    1 empty, light noise) through both demodulators: the same records."""
    rng = np.random.default_rng(5)
    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
    p = rng.integers(0, 256, (4, 4)).astype(np.uint8)
    fr = tapi.modulate(tapi.encode(p, cfg, device="cpu"), cfg).numpy()
    T = tapi.required_samples(cfg)
    x = np.zeros((4, T), np.complex64)
    for b, d in ((0, 0), (2, 37), (3, 300)):
        x[b, d : d + fr.shape[1]] = fr[b]
    x += 0.05 * (rng.standard_normal(x.shape)
                 + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    got = trace.frame_events(tapi.demodulate(x, cfg, device="cpu"), cfg)
    want = jtrace.frame_events(japi.demodulate(jnp.asarray(x), cfg), cfg)
    assert [e["channel"] for e in got] == [0, 2, 3]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(w[k], float):
                assert g[k] == pytest.approx(w[k], abs=FIELD_TOL), k
            else:
                assert g[k] == w[k], k
    assert got[0]["t_preamble"] == 0


def test_profile_writes_a_trace(tmp_path):
    """profile(None) runs the region untraced; profile(dir) around a CPU
    demodulate writes a Chrome trace that names the region's ops."""
    cfg = tapi.LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
    iq = tapi.modulate(tapi.encode(np.arange(4, dtype=np.uint8)[None], cfg,
                                   device="cpu"), cfg)
    with trace.profile(None):
        dem = tapi.demodulate(iq, cfg)
    assert bool(dem.found[0])
    assert not os.listdir(tmp_path)
    out = tmp_path / "trace"
    with trace.profile(str(out)):
        tapi.demodulate(iq, cfg)
    files = list(out.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("fft" in str(e.get("name", "")) for e in events)


def test_profile_does_not_hide_a_failure(tmp_path):
    """Unlike lora_tpu's hook, an exception in the region propagates once:
    the region is not run a second time untraced."""
    runs = []
    with pytest.raises(ZeroDivisionError):
        with trace.profile(str(tmp_path)):
            runs.append(1)
            1 / 0
    assert runs == [1]


# device kernel names as torch.profiler records them on the card (demangled:
# a template's return type and arguments, an untemplated kernel's neither)
# -> the launches kernel_launches counts for each
_F2 = "(float2 const*, long long, long long, long long, float const*)"
PROFILED = [
    (f"void lora::detect_kernel<10, false>{_F2}", {"detect": 1}),
    (f"void lora::track_kernel<7>{_F2}", {"track": 1}),
    (f"void lora::payload_kernel<9, true>{_F2}", {"payload": 1}),
    (f"void lora::channelize_fft_kernel<6, 8>{_F2}", {"channelize": 1}),
    (f"lora::channelize_kernel{_F2}", {"channelize": 1}),
    (f"void lora::channelize_mma_kernel<4, 8>{_F2}", {"channelize": 1}),
    ("lora::shift_kernel(float2 const*, long long, long long, int const*, "
     "float2*)", {"shift": 1}),
    ("lora::modulate_kernel(int const*, long long, int, float2 const*, int, "
     "unsigned int)", {"modulate": 1}),
    ("void lora::decode_kernel<short>(short const*, lora::DecodeGeo, "
     "long long const*)", {"decode": 1}),
    ("lora::resample_kernel(float2 const*, long long, long long, long long, "
     "long long, int const*, long long, int, float const*, int, float2*)",
     {"resample": 1}),
    ("void lora::resample_kernel<5, 8, 14>(float2 const*, long long, "
     "long long, long long, long long, int const*, long long, float const*, "
     "int, lora::Weights<70>, float2*)", {"resample": 1, "blocked": 1}),
    ("at::cuda::(anonymous namespace)::spin_kernel(long)", {}),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul>)", {}),
]


@pytest.mark.parametrize("name,want", PROFILED, ids=[
    "detect", "track", "payload", "channelize_fft", "channelize_direct",
    "channelize_mma", "shift", "modulate", "decode", "resample_general",
    "resample_blocked", "absorb", "foreign"])
def test_kernel_launches_read_from_profiled_names(name, want):
    """kernel_launches counts a launch of each family by its lora:: name,
    kernel R's register-blocked launches apart by their template arguments,
    and neither the session's absorb kernel nor a kernel outside lora::;
    each family is counted whatever else the record holds."""
    assert trace.absorbing(name) == ("spin_kernel" in name)
    zero = dict.fromkeys(trace.KERNELS + ("blocked",), 0)
    assert trace.kernel_launches([name]) == {**zero, **want}
    twice = trace.kernel_launches([name, PROFILED[-1][0], name])
    assert twice == {k: 2 * n for k, n in {**zero, **want}.items()}


@pytest.mark.parametrize("ask", ["flag", "env"])
def test_bench_cpu_record(ask, capsys, monkeypatch):
    """The CPU record, asked for by --device cpu or LORA_BENCH_FORCE=cpu:
    one JSON line with lora_tpu's keys and unit, the rung's median, min and
    max, the bf16 check on stderr."""
    if ask == "flag":
        argv = ["--device", "cpu", "--validate"]
        monkeypatch.delenv("LORA_BENCH_FORCE", raising=False)
    else:
        argv = ["--validate"]
        monkeypatch.setenv("LORA_BENCH_FORCE", "cpu")
    assert benchmarks.main(argv) == 0
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "mode",
                        "batch", "rungs", "backend", "device"}
    assert rec["metric"] == "demod_throughput_sf10"
    assert rec["unit"] == "Msamples/s/chip"
    assert rec["value"] > 0 and rec["vs_baseline"] == rec["value"] / 0.5
    assert rec["backend"] == "cpu" and rec["batch"] == 8
    assert rec["mode"] == "auto"
    (tag, rung), = rec["rungs"].items()
    assert tag == "sf10-auto/B8" and rung["calls"] == 2
    assert rung["min_ms"] <= rung["median_ms"] <= rung["max_ms"]
    assert rung["msamples_s"] == rec["value"]
    assert rung["samples"] == tapi.required_samples(benchmarks.bench_cfg(10))
    check = [json.loads(l) for l in cap.err.splitlines() if l.startswith("{")]
    assert check == [{"check": "bf16_vs_f32_decisions", "ok": True}]


def test_bench_bank_matches_jax_modulate():
    """The bank without noise is lora_tpu's modulate(encode(payload)) of
    the same payload bytes, zero-padded to T; the noise is sigma 0.1."""
    cfg = benchmarks.bench_cfg(10)
    T = tapi.required_samples(cfg)
    B = 2
    x = benchmarks.build_input(cfg, B, T, "cpu", sigma=0.0)
    jcfg = lora_tpu.LoRaConfig(sf=10, cr="4/8", ampl=1.0)
    jcfg = jcfg.replace(mtu=jcfg.num_symbols(32) + 4)
    assert jcfg.mtu == cfg.mtu and T == 98304
    pay = jnp.asarray(np.random.default_rng(0).integers(0, 256, (B, 32),
                                                        dtype=np.uint8))
    want = jcplx.to_complex(japi.modulate(japi.encode(pay, jcfg), jcfg))
    assert x.shape == (B, T) and x.dtype == torch.complex64
    assert_samples_close(x[:, : want.shape[1]], want)
    assert not bool(x[:, want.shape[1]:].any())
    noisy = benchmarks.build_input(cfg, B, T, "cpu")
    sigma = float((noisy - x)[:, want.shape[1]:].real.std())
    assert abs(sigma - 0.1) < 0.002


def test_bench_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LORA_BENCH_FORCE", raising=False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        benchmarks.main([])
    assert capsys.readouterr().out == ""


def test_bench_failing_rung_prints_the_error_record(capsys, monkeypatch):
    """A rung that fails ends the run: the error record with value 0.0,
    then the exception; no other mode is tried."""
    calls = []

    def fail(x, cfg, fused, n):
        calls.append(fused)
        raise AssertionError(f"fused={fused}: bench frames must all sync")

    monkeypatch.setattr(benchmarks, "run_rung", fail)
    with pytest.raises(AssertionError, match="must all sync"):
        benchmarks.main(["--device", "cpu"])
    rec = json.loads(capsys.readouterr().out)
    assert rec["value"] == 0.0 and rec["vs_baseline"] == 0.0
    assert "must all sync" in rec["error"]
    assert calls == ["auto"]
