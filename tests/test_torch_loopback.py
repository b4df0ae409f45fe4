"""The port's whole slice against lora_tpu on the same numpy banks: SF7 and
SF8, 8 channels with per-channel delay, CFO, phase and numpy noise handed to
both packages.  Frame fields identical to lora_tpu.demodulate(fused="off"),
dB values and fine CFO within 1e-3, payloads byte-exact; plus the port's
own loopback at the reference noise operating point."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lora_tpu
from lora_tpu import api as japi

from lora_tpu_torch import api as tapi

torch.set_num_threads(1)

EXACT = ("found", "symbols", "t_sync", "consumed", "count", "freq_error",
         "found_pre", "t_candidate", "payload_complete")
CLOSE = ("power", "snr", "fine_freq")


def _bank(cfg, rng, B, L, noise, half_bin=False):
    """Frames of random L-byte payloads at random delays in [0, 3N) with a
    CFO, phase and AWGN; the last channel is noise only.  The CFO is k + u
    bins, k in -2..2, with |u| < 0.4, or 0.45 <= |u| < 0.5 for `half_bin`."""
    payload = rng.integers(0, 256, (B, L)).astype(np.uint8)
    frames = tapi.modulate(tapi.encode(payload, cfg, device="cpu"), cfg).numpy()
    T = tapi.required_samples(cfg)
    N = cfg.N
    x = np.zeros((B, T), np.complex64)
    for b in range(B - 1):
        d = int(rng.integers(0, 3 * N))
        n = min(frames.shape[1], T - d)
        x[b, d : d + n] = frames[b, :n]
    cfo = rng.integers(-2, 3, (B, 1))
    if half_bin:
        cfo = cfo + rng.uniform(0.45, 0.5, (B, 1)) * rng.choice([-1, 1], (B, 1))
    else:
        cfo = cfo + rng.uniform(-0.4, 0.4, (B, 1))
    phase = rng.uniform(0, 2 * np.pi, (B, 1))
    x *= np.exp(2j * np.pi * cfo * np.arange(T) / N + 1j * phase)
    x += noise * (rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T)))
    return x.astype(np.complex64), payload


@pytest.mark.parametrize("sf,cr", [(7, "4/8"), (8, "4/5")])
def test_slice_matches_jax(sf, cr):
    rng = np.random.default_rng(sf)
    cfg = lora_tpu.LoRaConfig(sf=sf, cr=cr, ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(10) + 4)
    B = 8
    x, payload = _bank(cfg, rng, B, 10, 0.3)
    jdem = japi.demodulate(jnp.asarray(x), cfg, fused="off")
    assert np.asarray(jdem.found)[: B - 1].all()
    for fused in ("off", "auto"):
        tdem = tapi.demodulate(torch.as_tensor(x), cfg, fused=fused)
        for f in EXACT:
            np.testing.assert_array_equal(
                getattr(tdem, f).numpy(), np.asarray(getattr(jdem, f)),
                err_msg=f"{fused}:{f}")
        for f in CLOSE:
            np.testing.assert_allclose(
                getattr(tdem, f).numpy(), np.asarray(getattr(jdem, f)),
                atol=1e-3, err_msg=f"{fused}:{f}")
    jdec = japi.decode(jdem.symbols.astype(jnp.int32), cfg)
    tdec = tapi.decode(tdem.symbols, cfg)
    for f in dataclasses.fields(tdec):
        np.testing.assert_array_equal(getattr(tdec, f.name).numpy(),
                                      np.asarray(getattr(jdec, f.name)),
                                      err_msg=f.name)
    got = tapi.extract_payloads(tdec)
    assert got == japi.extract_payloads(jdec)
    assert got[: B - 1] == [bytes(p) for p in payload[: B - 1].tolist()]


@pytest.mark.parametrize("sf,cr,seed,lost,wrong", [
    (7, "4/8", 0, [], [1]),
    (7, "4/8", 4, [2], []),
    (7, "4/8", 8, [11], []),
    (8, "4/5", 3, [], [14]),
    (8, "4/5", 7, [4], []),
    (8, "4/5", 13, [], [11]),
])
def test_half_bin_cfo_matches_jax(sf, cr, seed, lost, wrong):
    """CFOs of k + u bins with 0.45 <= |u| < 0.5 split the preamble peaks
    between two bins; both packages then lose or misdecode the same frames
    (the channels `lost` and `wrong` of these seeds), and agree on all the
    rest."""
    rng = np.random.default_rng(seed)
    cfg = lora_tpu.LoRaConfig(sf=sf, cr=cr, ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(10) + 4)
    B = 16
    x, payload = _bank(cfg, rng, B, 10, 0.1, half_bin=True)
    jdem = japi.demodulate(jnp.asarray(x), cfg, fused="off")
    for fused in ("off", "auto"):
        tdem = tapi.demodulate(torch.as_tensor(x), cfg, fused=fused)
        for f in EXACT:
            np.testing.assert_array_equal(
                getattr(tdem, f).numpy(), np.asarray(getattr(jdem, f)),
                err_msg=f"{fused}:{f}")
        for f in CLOSE:
            np.testing.assert_allclose(
                getattr(tdem, f).numpy(), np.asarray(getattr(jdem, f)),
                atol=1e-3, err_msg=f"{fused}:{f}")
    got = tapi.extract_payloads(tapi.decode(tdem.symbols, cfg))
    assert got == japi.extract_payloads(
        japi.decode(jdem.symbols.astype(jnp.int32), cfg))
    want = [bytes(p) for p in payload.tolist()]
    found = tdem.found.numpy()
    assert [b for b in range(B - 1) if not found[b]] == lost
    assert [b for b in range(B - 1)
            if found[b] and got[b] != want[b]] == wrong


def test_single_buffer_and_short_input():
    """A 1-D buffer shorter than required_samples is padded and squeezed,
    as in the JAX package."""
    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/7", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(6) + 2)
    payload = np.arange(6, dtype=np.uint8)
    frame = tapi.modulate(tapi.encode(payload, cfg, device="cpu"), cfg)
    dem = tapi.demodulate(frame, cfg)
    jdem = japi.demodulate(jnp.asarray(frame.numpy()), cfg, fused="off")
    assert dem.found.shape == () and bool(dem.found)
    for f in EXACT:
        np.testing.assert_array_equal(getattr(dem, f).numpy(),
                                      np.asarray(getattr(jdem, f)), err_msg=f)
    assert tapi.extract_payloads(tapi.decode(dem.symbols, cfg)) == [
        bytes(payload)]


@pytest.mark.parametrize("cr,L,seed", [("4/8", 8, 0), ("4/7", 33, 1)])
def test_loopback_reference_operating_point(cr, L, seed):
    """SF10, signal 1.0 against AWGN of amplitude 4.0 (BASELINE.md:25,
    TestLoopback.cpp:93-101): byte-exact through the plain route."""
    cfg = lora_tpu.LoRaConfig(sf=10, cr=cr, ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(L) + 4)
    payload = np.random.default_rng(seed).integers(0, 256, (2, L)).astype(
        np.uint8)
    dec, dem = tapi.loopback(payload, cfg, noise_amplitude=4.0, seed=seed,
                             delay=300, phase=np.pi / 1.2345, device="cpu")
    assert bool(dem.found.all())
    assert tapi.extract_payloads(dec) == [bytes(p) for p in payload.tolist()]


def test_out_of_slice_options_raise():
    """The one option of lora_tpu.demodulate still outside the port is a
    `fused` route other than "auto" and "off" (ROADMAP.md item 13); the
    options of the receive slice (multi-frame, debug taps, spectra, soft
    decoding) are accepted."""
    cfg = lora_tpu.LoRaConfig(sf=7, mtu=8)
    x = torch.zeros(tapi.required_samples(cfg), dtype=torch.complex64)
    for fused in ("bf16", "interpret", "interpret-bf16"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md item 13"):
            tapi.demodulate(x, cfg, fused=fused)
        with pytest.raises(NotImplementedError, match="ROADMAP.md item 13"):
            tapi.loopback(np.zeros(4, np.uint8), cfg, fused=fused,
                          device="cpu")
    for kw in (dict(max_frames=2), dict(debug=True), dict(spectra=True)):
        assert not bool(tapi.demodulate(x, cfg, **kw).found.any())
    dec, _ = tapi.loopback(np.arange(4, dtype=np.uint8),
                           cfg.replace(mtu=cfg.num_symbols(4)), soft=True,
                           device="cpu")
    assert tapi.extract_payloads(dec) == [bytes(range(4))]
