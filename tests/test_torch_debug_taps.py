"""demodulate(debug=True) and (spectra=True), loopback(soft=True) and
channelized_demodulate(spectra=True) against lora_tpu on the same numpy
banks (SF7, SF8).  Integer fields equal; the copy tap `raw` within 1e-6;
`dec` and `fft_mag2` within 1e-4 of each window's largest value; dB values
within 1e-3; soft-decoded statuses and bytes equal."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lora_tpu
from lora_tpu import api as japi

import lora_tpu_torch
from lora_tpu_torch import api as tapi

torch.set_num_threads(1)

EXACT = ("found", "symbols", "t_sync", "consumed", "count", "freq_error",
         "found_pre", "t_candidate", "payload_complete")
CLOSE = ("power", "snr", "fine_freq")


def _cfgs(L, **fields):
    fields = dict(fields, ampl=1.0)
    j = lora_tpu.LoRaConfig(**fields)
    mtu = j.num_symbols(L) + 4
    return j.replace(mtu=mtu), lora_tpu_torch.LoRaConfig(**fields, mtu=mtu)


def _bank(cfg, rng, B, L, noise):
    """Frames of random payloads at random delays with a CFO, a phase and
    noise; the last channel is noise only."""
    payload = rng.integers(0, 256, (B, L)).astype(np.uint8)
    frames = tapi.modulate(tapi.encode(payload, cfg, device="cpu"), cfg).numpy()
    T, N = tapi.required_samples(cfg), cfg.N
    x = np.zeros((B, T), np.complex64)
    for b in range(B - 1):
        d = int(rng.integers(0, 3 * N))
        n = min(frames.shape[1], T - d)
        x[b, d : d + n] = frames[b, :n]
    cfo = rng.integers(-2, 3, (B, 1)) + rng.uniform(-0.4, 0.4, (B, 1))
    x *= np.exp(2j * np.pi * cfo * np.arange(T) / N
                + 1j * rng.uniform(0, 2 * np.pi, (B, 1)))
    x += noise * (rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T)))
    return x.astype(np.complex64), payload


def _planar(iq):
    return np.asarray(iq.re) + 1j * np.asarray(iq.im)


def _fields_match(tdem, jdem, what):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(tdem, f).numpy(),
                                      np.asarray(getattr(jdem, f)),
                                      err_msg=f"{what}:{f}")
    for f in CLOSE:
        np.testing.assert_allclose(getattr(tdem, f).numpy(),
                                   np.asarray(getattr(jdem, f)), atol=1e-3,
                                   err_msg=f"{what}:{f}")


def _windows_close(got, want, what):
    """Within 1e-4 of each window's largest magnitude."""
    got, want = got.numpy(), np.asarray(want)
    peak = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got - want) <= 1e-4 * peak + 1e-30).all(), what


@pytest.mark.parametrize("sf,cr", [(7, "4/8"), (8, "4/5")])
def test_debug_taps_match_jax(sf, cr):
    rng = np.random.default_rng(20 + sf)
    jcfg, tcfg = _cfgs(10, sf=sf, cr=cr)
    B = 6
    x, payload = _bank(tcfg, rng, B, 10, 0.3)
    jdem = japi.demodulate(jnp.asarray(x), jcfg, debug=True, fused="off")
    assert np.asarray(jdem.found)[: B - 1].all()
    for fused in ("off", "auto"):
        tdem = tapi.demodulate(torch.as_tensor(x), tcfg, debug=True,
                               fused=fused)
        _fields_match(tdem, jdem, fused)
        shape = (B, tcfg.mtu, tcfg.N)
        assert tdem.raw.shape == tdem.dec.shape == tdem.fft_mag2.shape == shape
        assert tdem.raw.dtype == tdem.dec.dtype == torch.complex64
        assert tdem.fft_mag2.dtype == torch.float32
        np.testing.assert_allclose(tdem.raw.numpy(), _planar(jdem.raw),
                                   atol=1e-6, rtol=0)
        _windows_close(tdem.dec, _planar(jdem.dec), f"{fused}:dec")
        _windows_close(tdem.fft_mag2, jdem.fft_mag2, f"{fused}:fft_mag2")
        # the taps are the symbol decisions' evidence
        found = tdem.found.numpy()
        np.testing.assert_array_equal(
            tdem.fft_mag2.argmax(-1).numpy()[found][:, :8],
            tdem.symbols.numpy()[found][:, :8])
    # raw is the buffer itself from each frame's data start
    ds = (tdem.consumed - tdem.count * tcfg.N).numpy()
    for b in range(B - 1):
        np.testing.assert_array_equal(
            tdem.raw[b].reshape(-1).numpy(),
            x[b, ds[b] : ds[b] + tcfg.mtu * tcfg.N])


@pytest.mark.parametrize("jfused", ["off", "interpret"])
@pytest.mark.parametrize("sf,cr", [(7, "4/8"), (8, "4/5")])
def test_spectra_match_jax(sf, cr, jfused):
    rng = np.random.default_rng(30 + sf)
    jcfg, tcfg = _cfgs(10, sf=sf, cr=cr, crc_check=True)
    B = 6
    x, payload = _bank(tcfg, rng, B, 10, 0.5)
    jdem = japi.demodulate(jnp.asarray(x), jcfg, spectra=True, fused=jfused)
    jdec = japi.decode_soft(jdem.fft_mag2, jcfg)
    for fused in ("off", "auto"):
        tdem = tapi.demodulate(torch.as_tensor(x), tcfg, spectra=True,
                               fused=fused)
        _fields_match(tdem, jdem, fused)
        assert tdem.raw is None and tdem.dec is None
        _windows_close(tdem.fft_mag2, jdem.fft_mag2, f"{fused}:fft_mag2")
        tdec = tapi.decode_soft(tdem.fft_mag2, tcfg)
        for f in dataclasses.fields(tdec):
            np.testing.assert_array_equal(getattr(tdec, f.name).numpy(),
                                          np.asarray(getattr(jdec, f.name)),
                                          err_msg=f.name)
        got = tapi.extract_payloads(tdec)
        assert got[: B - 1] == [bytes(p) for p in payload[: B - 1].tolist()]
        assert got[B - 1] is None
    # without the option the result carries no spectra
    assert tapi.demodulate(torch.as_tensor(x), tcfg).fft_mag2 is None


def test_debug_single_buffer_squeezes():
    jcfg, tcfg = _cfgs(6, sf=7, cr="4/7")
    payload = np.arange(6, dtype=np.uint8)
    frame = tapi.modulate(tapi.encode(payload, tcfg, device="cpu"), tcfg)
    dem = tapi.demodulate(frame, tcfg, debug=True)
    jdem = japi.demodulate(jnp.asarray(frame.numpy()), jcfg, debug=True,
                           fused="off")
    assert dem.found.shape == () and bool(dem.found)
    assert dem.raw.shape == dem.dec.shape == (tcfg.mtu, tcfg.N)
    _fields_match(dem, jdem, "1-D")
    _windows_close(dem.fft_mag2, jdem.fft_mag2, "fft_mag2")


@pytest.mark.parametrize("debug", [False, True])
def test_loopback_soft_matches_jax_decisions(debug):
    """loopback(soft=True): spectra-only normally, the debug taps' spectra
    with debug=True; a noisy frame decodes byte-exactly either way, and the
    JAX package decodes the port's spectra to the same result."""
    jcfg, tcfg = _cfgs(8, sf=7, cr="4/8", crc_check=True)
    payload = np.random.default_rng(4).integers(0, 256, (3, 8)).astype(np.uint8)
    dec, dem = tapi.loopback(payload, tcfg, noise_amplitude=1.0, delay=77,
                             cfo_bins=1.3, phase=0.7, seed=5, debug=debug,
                             soft=True, device="cpu")
    assert (dem.raw is not None) == debug and dem.fft_mag2 is not None
    assert tapi.extract_payloads(dec) == [bytes(p) for p in payload.tolist()]
    jdec = japi.decode_soft(jnp.asarray(dem.fft_mag2.numpy()), jcfg)
    for f in dataclasses.fields(dec):
        np.testing.assert_array_equal(getattr(dec, f.name).numpy(),
                                      np.asarray(getattr(jdec, f.name)),
                                      err_msg=f.name)
    margin = tapi.soft_symbols(dem.fft_mag2, tcfg)[1]
    assert margin.shape == (3,) and bool((margin > 0).all())


def test_channelized_spectra_shape_and_decode():
    """channelized_demodulate(spectra=True) carries fft_mag2 as
    [S, K, mtu, N]; the occupied channels soft-decode byte-exactly, and the
    integer fields equal the JAX package's."""
    jcfg, tcfg = _cfgs(6, sf=7, cr="4/8", crc_check=True)
    rng = np.random.default_rng(8)
    K, S = 4, 2
    N, M = tcfg.N, tapi.required_samples(tcfg) + 64
    payload = rng.integers(0, 256, (S, 6)).astype(np.uint8)
    frames = tapi.modulate(tapi.encode(payload, tcfg, device="cpu"),
                           tcfg).numpy()
    n = np.arange(K * M)
    wide = np.zeros((S, K * M), np.complex64)
    chans = (1, 2)
    for s, c in enumerate(chans):
        nb = np.zeros(M, np.complex64)
        nb[40 : 40 + frames.shape[1]] = frames[s][: M - 40]
        wide[s] = np.repeat(nb, K) * np.exp(2j * np.pi * c * n / K)
    tdem, _ = tapi.channelized_demodulate(torch.as_tensor(wide), K, tcfg,
                                          spectra=True)
    jdem, _ = japi.channelized_demodulate(jnp.asarray(wide), K, jcfg,
                                          spectra=True, fused="off")
    assert tdem.fft_mag2.shape == (S, K, tcfg.mtu, N)
    assert np.asarray(jdem.fft_mag2).shape == (S, K, tcfg.mtu, N)
    got = tapi.extract_payloads(
        tapi.decode_soft(tdem.fft_mag2.reshape(-1, tcfg.mtu, N), tcfg))
    for s, c in enumerate(chans):
        assert bool(tdem.found[s, c])
        assert got[s * K + c] == bytes(payload[s].tolist())
        for f in ("symbols", "count", "t_sync", "freq_error"):
            np.testing.assert_array_equal(
                getattr(tdem, f)[s, c].numpy(),
                np.asarray(getattr(jdem, f))[s, c], err_msg=f)
