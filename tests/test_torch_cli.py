"""The port's CLI (python -m lora_tpu_torch.cli), packet sources, top-level
API and numeric sanitizer against lora_tpu's: the CLI and source cases of
tests/test_cli_and_utils.py and the top-level and debug_checks cases of
tests/test_aux.py, plus the repaired fused="bf16" route.

The JSON lines of `loopback` at noise 0 and of `replay` equal lora_tpu's
(floats within 1e-3, as the demodulator's dB values agree).  The `tx`
files are not byte-equal: the two packages' float32 cos/sin differ in the
last bit on about 5% of the samples (XLA's CPU routines against
PyTorch's), so their samples are held within 6e-8 (one unit in the last
place below 1.0), the zero lead-in and lead-out bytes equal, and each
package's replay of either file gives the same frames."""

import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lora_tpu
import lora_tpu_torch
from lora_tpu import api as japi
from lora_tpu import cli as jcli
from lora_tpu.config import LoRaConfig
from lora_tpu_torch import api as tapi
from lora_tpu_torch import cli as tcli

REPO = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def run_main(main, argv, capsys):
    rc = main(argv)
    return rc, [json.loads(l) for l in capsys.readouterr().out.splitlines()
                if l.startswith("{")]


def assert_lines_close(got, want, tol=1e-3):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(w[k], float):
                assert g[k] == pytest.approx(w[k], abs=tol), k
            else:
                assert g[k] == w[k], k


def test_testgen_counter_packets_match_jax():
    from lora_tpu.utils import TestGen as JGen
    from lora_tpu_torch.utils import TestGen

    g, jg = TestGen(), JGen()
    assert bytes(next(g)) == bytes(next(jg)) == b"0"
    assert bytes(next(g)) == b"1"
    next(jg)
    b = g.batch(3, pad_to=4)
    np.testing.assert_array_equal(b, jg.batch(3, pad_to=4))
    assert b.shape == (3, 4) and bytes(b[0]).rstrip() == b"2"


def test_blockgen_word_sizes_match_jax():
    from lora_tpu.utils import BlockGen as JBlock
    from lora_tpu_torch.utils import BlockGen

    for words, bits in (([0x1234, 0xBEEF], 16), ([1, 2, 255], 8),
                        ([0xDEADBEEF], 32)):
        g, jg = BlockGen(words, word_bits=bits), JBlock(words, word_bits=bits)
        pkt = g.next()
        assert pkt.tolist() == jg.next().tolist()
        assert g.next() is None
        g.trigger()
        assert g.next().tolist() == pkt.tolist()
    assert BlockGen([0x1234, 0xBEEF], 16).next().tolist() == [0x34, 0x12,
                                                              0xEF, 0xBE]
    with pytest.raises(ValueError):
        BlockGen([1], word_bits=12)


def test_cli_loopback_matches_jax(capsys, tmp_path):
    """loopback at noise 0 prints lora_tpu's JSON line; --dump-spectra
    renders the port's debug taps."""
    argv = ["loopback", "--sf", "7", "--noise", "0", "--packets", "3",
            "--length", "16"]
    rc, jl = run_main(jcli.main, argv, capsys)
    assert rc == 0
    png = tmp_path / "taps.png"
    rc, tl = run_main(tcli.main, argv + ["--device", "cpu", "--dump-spectra",
                                         str(png)], capsys)
    assert rc == 0
    assert_lines_close(tl, jl)
    assert tl[0]["byte_exact"] == 3 and tl[0]["decoded_ok"] == 3
    assert png.stat().st_size > 1000


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", "lora_tpu_torch.cli", *args],
                          capture_output=True, text=True, env=env, cwd=cwd,
                          timeout=300)


def test_cli_loopback_noisy_port(tmp_path):
    """The module entry point in a fresh process, under noise at SF7."""
    r = _cli("loopback", "--sf", "7", "--noise", "1.5", "--packets", "3",
             "--length", "16", "--device", "cpu", cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["byte_exact"] == 3 and out["decoded_ok"] == 3


def test_cli_tx_then_replay_matches_jax(capsys, tmp_path):
    tx = ["tx", "--sf", "7", "--payload", "48656c6c6f", "--lead-in", "500",
          "--lead-out", "8000"]
    fj, ft = tmp_path / "jax.cf32", tmp_path / "port.cf32"
    rc, jl = run_main(jcli.main, tx + ["--out", str(fj)], capsys)
    rc2, tl = run_main(tcli.main, tx + ["--out", str(ft), "--device", "cpu"],
                       capsys)
    assert rc == rc2 == 0
    assert tl[0]["samples"] == jl[0]["samples"]
    a = np.fromfile(ft, np.float32)
    b = np.fromfile(fj, np.float32)
    assert a.size == b.size == 2 * (500 + tl[0]["samples"] + 8000)
    body = slice(1000, a.size - 16000)
    assert a[:1000].tobytes() == b[:1000].tobytes()
    assert a[body.stop:].tobytes() == b[body.stop:].tobytes()
    np.testing.assert_allclose(a[body], b[body], rtol=0, atol=6e-8)
    replay = ["replay", "--fmt", "cf32", "--sf", "7", "--length", "5"]
    outs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        for f in (fj, ft):
            rc, lines = run_main(main, replay + ["--file", str(f)] + extra,
                                 capsys)
            assert rc == 0
            outs.append(lines)
    for lines in outs[1:]:
        assert_lines_close(lines, outs[0], tol=0.011)
    assert outs[3][-1]["frames"] == 1
    assert outs[3][0]["payload"] == "48656c6c6f" and outs[3][0]["status"] == 0


def test_cli_bench_prints_the_record(capsys, monkeypatch):
    """`bench --device cpu` prints the benchmark's CPU record, one line with
    lora_tpu's keys; without the CPU asked for and without a card it
    refuses."""
    rc, lines = run_main(tcli.main, ["bench", "--device", "cpu"], capsys)
    assert rc == 0 and len(lines) == 1
    rec = lines[0]
    assert rec["metric"] == "demod_throughput_sf10" and rec["value"] > 0
    assert rec["backend"] == "cpu" and rec["batch"] == 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LORA_BENCH_FORCE", raising=False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["bench"])
    assert capsys.readouterr().out == ""


def test_top_level_lazy_exports_match_jax():
    """The port's lazy top-level names are lora_tpu's, but for IQ, which
    raises (the port keeps complex64 tensors); parallel resolves to the
    port's multi-device package, with make_mesh as in lora_tpu."""
    for name in ("encode", "decode", "decode_soft", "soft_symbols",
                 "modulate", "demodulate", "loopback", "required_samples",
                 "extract_payloads", "debug_checks"):
        assert callable(getattr(lora_tpu_torch, name)), name
        assert callable(getattr(lora_tpu, name)), name
    assert lora_tpu_torch.DemodResult is tapi.DemodResult
    assert lora_tpu_torch.DecodeResult is tapi.DecodeResult
    assert issubclass(lora_tpu_torch.DemodCheckError, AssertionError)
    for sub in ("runtime", "api", "models", "ops", "sim", "utils", "hw",
                "parallel"):
        assert getattr(lora_tpu_torch, sub).__name__ == f"lora_tpu_torch.{sub}"
    assert hasattr(lora_tpu_torch.runtime, "StreamDemodulator")
    assert hasattr(lora_tpu_torch.runtime, "demodulate_bank")
    assert hasattr(lora_tpu_torch.hw, "RN2483")
    assert lora_tpu.IQ is not None and hasattr(lora_tpu.parallel, "make_mesh")
    with pytest.raises(AttributeError, match="complex64"):
        lora_tpu_torch.IQ
    assert callable(lora_tpu_torch.parallel.make_mesh)
    with pytest.raises(AttributeError):
        lora_tpu_torch.no_such_name


def _frames(cfg, rng, B=2, L=4):
    p = rng.integers(0, 256, (B, L)).astype(np.uint8)
    return tapi.modulate(tapi.encode(p, cfg, device="cpu"), cfg).numpy()


def test_debug_checks_sanitizer_matches_jax(rng):
    """Armed, demodulate carries spectra and passes clean frames; a NaN in
    a payload raises DemodCheckError in both packages; disarmed, the same
    input returns."""
    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
    iq = _frames(cfg, rng)
    check = lora_tpu_torch.utils.debugcheck
    assert not check.armed()
    with lora_tpu_torch.debug_checks():
        assert check.armed()
        dem = tapi.demodulate(iq, cfg, device="cpu")
        assert dem.fft_mag2 is not None and bool(dem.found.all())
    assert not check.armed()
    bad = iq.copy()
    bad[1, -3 * cfg.N :] = np.nan
    with lora_tpu_torch.debug_checks():
        with pytest.raises(lora_tpu_torch.DemodCheckError, match="lane"):
            tapi.demodulate(bad, cfg, device="cpu")
    with lora_tpu.debug_checks():
        with pytest.raises(lora_tpu.DemodCheckError):
            japi.demodulate(jnp.asarray(bad), cfg)
    tapi.demodulate(bad, cfg, device="cpu")


def test_debug_checks_channelized_and_threaded():
    """Armed checks run on channelized_demodulate's bank too (nothing is
    traced in the port), and arming stays with its context: a thread
    started inside is not armed."""
    from lora_tpu_torch.ops import channelizer as chz

    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
    nb = _frames(cfg, np.random.default_rng(1), B=1)[0]
    need = tapi.required_samples(cfg)
    nb = np.pad(nb, (32, need + 64 - nb.size - 32))
    K, chan = 4, 1
    wide = chz.upconvert(torch.as_tensor(nb), K, chan)
    wide = wide[: (wide.shape[-1] // K) * K]
    check = lora_tpu_torch.utils.debugcheck
    with lora_tpu_torch.debug_checks():
        dem, _ = tapi.channelized_demodulate(wide, K, cfg)
        assert bool(dem.found[chan]) and dem.fft_mag2 is not None
        seen = {}
        t = threading.Thread(target=lambda: seen.setdefault("armed",
                                                            check.armed()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen["armed"] is False


def test_fused_bf16_is_auto_and_matches_jax(rng):
    """fused="bf16" (a fault of the port until now) takes the "auto" route:
    on the CPU the port's result is bit-equal to its "auto" result, as
    lora_tpu's "bf16" is to its own "auto" off a TPU; the decisions are
    lora_tpu's, the dB values within 1e-3.  The interpret routes have no
    CUDA counterpart and say so."""
    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(6) + 4)
    x = np.zeros((3, tapi.required_samples(cfg)), np.complex64)
    fr = _frames(cfg, rng, B=3, L=6)
    x[:, 100 : 100 + fr.shape[1]] = fr
    x += 0.2 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    got = tapi.demodulate(x, cfg, fused="bf16", device="cpu")
    auto = tapi.demodulate(x, cfg, fused="auto", device="cpu")
    jgot = japi.demodulate(jnp.asarray(x), cfg, fused="bf16")
    jauto = japi.demodulate(jnp.asarray(x), cfg, fused="auto")
    for f in ("found", "symbols", "count", "t_sync", "consumed", "freq_error",
              "found_pre", "t_candidate", "payload_complete", "power", "snr",
              "fine_freq"):
        assert torch.equal(getattr(got, f), getattr(auto, f)), f
        np.testing.assert_array_equal(np.asarray(getattr(jgot, f)),
                                      np.asarray(getattr(jauto, f)))
        want = np.asarray(getattr(jgot, f))
        if getattr(got, f).dtype.is_floating_point:
            np.testing.assert_allclose(getattr(got, f).numpy(), want, atol=1e-3)
        else:
            np.testing.assert_array_equal(getattr(got, f).numpy(), want)
    dec, _ = tapi.loopback(np.arange(6, dtype=np.uint8), cfg, fused="bf16",
                           device="cpu")
    assert tapi.extract_payloads(dec) == [bytes(range(6))]
    for fused in ("interpret", "interpret-bf16"):
        with pytest.raises(NotImplementedError, match="no CUDA counterpart"):
            tapi.demodulate(x, cfg, fused=fused, device="cpu")
