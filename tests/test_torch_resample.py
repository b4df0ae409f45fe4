"""The port's fractional resampler (lora_tpu_torch.ops.resample) and
sim.channel.clock_drift against lora_tpu's on the same numpy inputs: one
twin of every case of tests/test_resample.py.  The bank is bit-equal (the
same numpy design), the plan is equal (host float64), outputs agree within
2e-6 of the input's scale (float32 sums of the same terms in an order XLA
picks), and a chunked resample_stream is bit-equal to the unchunked
resample in the port itself."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lora_tpu import api as japi
from lora_tpu.config import LoRaConfig
from lora_tpu.ops import cplx as jcplx
from lora_tpu.ops import resample as jrs

from lora_tpu_torch import api as tapi
from lora_tpu_torch.ops import resample as trs
from lora_tpu_torch.ops import tables

torch.set_num_threads(1)

ATOL = 2e-6


def jresample(x, ratio):
    return jcplx.to_complex(jrs.resample(jcplx.from_complex(x), ratio))


def tresample(x, ratio):
    return trs.resample(x, ratio, device="cpu").numpy()


@pytest.mark.parametrize("num,den,taps", [(1, 1, 8), (1000, 4096, 34),
                                          (1000, 1700, 14), (1000, 1000, 10),
                                          (1000, 4000, 32)])
def test_bank_bit_equal_to_jax(num, den, taps):
    got = tables.resample_bank(num, den, taps)
    want = jrs._bank(num, den, taps)
    assert got.dtype == np.float32 and got.shape == (trs.NPHASE, taps)
    np.testing.assert_array_equal(got, want)
    assert trs.NPHASE == jrs.NPHASE and trs.TAPS == jrs.TAPS


@pytest.mark.parametrize("ratio", [4.096, 2.0, 0.37, 1.7, 1.00005, 0.244140625])
def test_plan_equals_jax(ratio):
    taps = trs._taps_eff(ratio)
    assert taps == jrs._taps_eff(ratio)
    for m0, M in ((0, 1000), (12345, 777)):
        for a, b in zip(trs._plan(m0, M, ratio, taps),
                        jrs._plan(m0, M, ratio, taps)):
            np.testing.assert_array_equal(a, b)


def test_tone_fidelity_matches_jax():
    T, f = 8192, 0.031
    x = np.exp(2j * np.pi * f * np.arange(T)).astype(np.complex64)
    for ratio in (4.096, 2.0, 0.37):
        y = tresample(x, ratio)
        np.testing.assert_allclose(y, jresample(x, ratio), rtol=0, atol=ATOL)
        m = np.arange(y.shape[-1])
        sl = slice(8, y.shape[-1] - 8)
        want = np.exp(2j * np.pi * f * ratio * m)
        rot = np.vdot(want[sl], y[sl])
        rot /= abs(rot)
        assert np.abs(y[sl] - rot * want[sl]).max() < 5e-3, ratio


def test_decimation_antialiases_matches_jax():
    T, ratio, f = 8192, 4.0, 0.9 * 0.5
    x = np.exp(2j * np.pi * f * np.arange(T)).astype(np.complex64)
    y = tresample(x, ratio)
    np.testing.assert_allclose(y, jresample(x, ratio), rtol=0, atol=ATOL)
    assert np.abs(y[8:-8]).mean() < 0.02  # > 34 dB rejection


def test_lora_frame_through_fractional_frontend_matches_jax(rng):
    """Interpolate a frame up by 4.096, resample it back down and decode
    byte-exact; every stage within ATOL of lora_tpu's, the decisions
    equal."""
    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(8) + 2)
    payload = rng.integers(0, 256, size=(1, 8)).astype(np.uint8)
    nb = tapi.modulate(tapi.encode(payload, cfg, device="cpu"), cfg)[0]
    nb = np.pad(nb.numpy(), (64, 512))
    wide = tresample(nb, 1.0 / 4.096)
    np.testing.assert_allclose(wide, jresample(nb, 1.0 / 4.096), rtol=0,
                               atol=ATOL)
    back = tresample(wide, 4.096)
    np.testing.assert_allclose(back, jresample(wide, 4.096), rtol=0,
                               atol=ATOL)
    dem = tapi.demodulate(back[None], cfg, device="cpu")
    jdem = japi.demodulate(jnp.asarray(back[None]), cfg)
    for f in ("found", "symbols", "t_sync", "freq_error"):
        np.testing.assert_array_equal(getattr(dem, f).numpy(),
                                      np.asarray(getattr(jdem, f)))
    dec = tapi.decode(dem.symbols, cfg)
    assert tapi.extract_payloads(dec)[0] == bytes(payload[0].tolist())


def _capture(tmp_path, cfg, payload, pad):
    """A cf32 file of one frame at 4.096x the channel rate, written with
    the port's iqio."""
    from lora_tpu_torch.runtime import iqio

    nb = tapi.modulate(tapi.encode(np.frombuffer(payload, np.uint8)[None],
                                   cfg, device="cpu"), cfg)[0]
    wide = trs.resample(torch.nn.functional.pad(nb, pad), 1.0 / 4.096)
    f = tmp_path / "cap.cf32"
    f.write_bytes(iqio.interleave_cf32(wide.real.numpy(),
                                       wide.imag.numpy()).tobytes())
    return str(f)


def _replays(path, cfg, **kw):
    from lora_tpu.hw.capture import replay_file as jreplay
    from lora_tpu_torch.hw.capture import replay_file as treplay

    tf = treplay(path, "cf32", cfg, device="cpu", **kw)
    jf = jreplay(path, "cf32", cfg, **kw)
    key = lambda f: (f.t_start, f.data_start, f.freq_error, f.payload,
                     f.status, tuple(int(s) for s in f.symbols))
    assert [key(f) for f in tf] == [key(f) for f in jf]
    return tf


def test_replay_fractional_capture_rate_matches_jax(tmp_path):
    cfg = LoRaConfig(sf=7, cr="4/6", ampl=0.8)
    cfg = cfg.replace(mtu=cfg.num_symbols(6) + 2)
    path = _capture(tmp_path, cfg, b"fracRs", (300, 2000))
    frames = _replays(path, cfg, capture_rate=4.096e5, channel_rate=1e5)
    assert len(frames) == 1 and frames[0].payload == b"fracRs"


def test_resample_stream_bit_equal_to_full_and_close_to_jax(rng):
    """Chunked streaming at awkward cuts equals the one-shot resample bit
    for bit (no grid restarts at the seams); both within ATOL of
    lora_tpu's."""
    T = 20000
    x = (rng.standard_normal(T) + 1j * rng.standard_normal(T)).astype(
        np.complex64)
    cuts = [0, 1037, 1038, 5000, 5001, 12345, 17000, T]
    for ratio in (4.096, 1.7, 0.37):
        full = tresample(x, ratio)
        state, parts = None, []
        for a, b in zip(cuts[:-1], cuts[1:]):
            y, state = trs.resample_stream(x[a:b], ratio, state, device="cpu")
            assert y.device.type == "cpu" and state.tail.device.type == "cpu"
            parts.append(y.numpy())
        got = np.concatenate(parts)
        n = min(got.size, full.size)
        assert n >= full.size - 8, (ratio, n, full.size)
        np.testing.assert_array_equal(got[:n], full[:n], err_msg=str(ratio))
        np.testing.assert_allclose(full, jresample(x, ratio), rtol=0,
                                   atol=4 * ATOL)


def test_replay_fractional_frame_straddles_chunks_matches_jax(tmp_path):
    """Chunks of 2048 capture samples (500 channel samples): the frame
    spans about ten seams of the stateful resampler."""
    cfg = LoRaConfig(sf=7, cr="4/6", ampl=0.8)
    cfg = cfg.replace(mtu=cfg.num_symbols(6) + 2)
    path = _capture(tmp_path, cfg, b"seams!", (300, 2000))
    frames = _replays(path, cfg, capture_rate=4.096e5, channel_rate=1e5,
                      chunk=2048)
    assert len(frames) == 1 and frames[0].payload == b"seams!"


def test_clock_drift_matches_jax(rng):
    """sim.channel.clock_drift (a fault of the port until now): +-50 ppm
    through the resampler, within ATOL of lora_tpu's, and the frame still
    decodes byte-exact."""
    from lora_tpu.sim import channel as jch
    from lora_tpu_torch.sim import channel as tch

    payload = rng.integers(0, 256, size=(1, 16)).astype(np.uint8)
    cfg = LoRaConfig(sf=7, ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 4)
    iq = tapi.modulate(tapi.encode(payload, cfg, device="cpu"), cfg)
    need = -(-(tapi.required_samples(cfg) + 300) // 4096) * 4096
    iq = torch.nn.functional.pad(iq, (300, need - 300 - iq.shape[-1]))
    for ppm in (-50.0, 50.0):
        got = tch.clock_drift(iq, ppm)
        want = jcplx.to_complex(jch.clock_drift(jcplx.from_complex(
            iq.numpy()), ppm))
        assert got.shape == iq.shape and got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        dem = tapi.demodulate(got, cfg)
        assert bool(dem.found[0]), ppm
        dec = tapi.decode(dem.symbols, cfg)
        assert tapi.extract_payloads(dec)[0] == bytes(payload[0].tolist())
