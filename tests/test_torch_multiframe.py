"""demodulate(max_frames=K) against lora_tpu on the same numpy banks: two
frames of unequal power per buffer (and buffers with one frame or none),
K = 2 and 3, against the JAX package's plain route (fused="off") and its
Pallas kernels in interpret mode.  Every field equal (dB values within
1e-3), also with debug=True and spectra=True; the plain versions of kernels
B and C take [B, K] candidates."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lora_tpu
from lora_tpu import api as japi

import lora_tpu_torch
from lora_tpu_torch import api as tapi
from lora_tpu_torch.models import demodulator as tdemod
from lora_tpu_torch.ops import cuda_demod

torch.set_num_threads(1)

EXACT = ("found", "symbols", "t_sync", "consumed", "count", "freq_error",
         "found_pre", "t_candidate", "payload_complete")
CLOSE = ("power", "snr", "fine_freq")


def _cfgs(L, **fields):
    fields = dict(fields, ampl=1.0)
    j = lora_tpu.LoRaConfig(**fields)
    mtu = j.num_symbols(L)
    return j.replace(mtu=mtu), lora_tpu_torch.LoRaConfig(**fields, mtu=mtu)


def _two_frame_bank(cfg, rng, B, L, noise):
    """Buffers of 2 * required_samples: a first frame at a random delay and
    a second, 6 dB weaker, after the first's end; channel B-2 holds one
    frame only and channel B-1 noise only."""
    payload = rng.integers(0, 256, (B, 2, L)).astype(np.uint8)
    frames = tapi.modulate(
        tapi.encode(payload.reshape(2 * B, L), cfg, device="cpu"),
        cfg).numpy().reshape(B, 2, -1)
    F, N = frames.shape[-1], cfg.N
    T = 2 * tapi.required_samples(cfg)
    x = np.zeros((B, T), np.complex64)
    starts = np.zeros((B, 2), np.int64)
    for b in range(B - 1):
        d0 = int(rng.integers(0, 2 * N))
        d1 = d0 + F + int(rng.integers(2 * N, 4 * N))
        x[b, d0 : d0 + F] += frames[b, 0]
        starts[b] = (d0, d1)
        if b < B - 2:
            x[b, d1 : d1 + F] += 0.5 * frames[b, 1]
    cfo = rng.uniform(-1.3, 1.3, (B, 1))
    x *= np.exp(2j * np.pi * cfo * np.arange(T) / N)
    x += noise * (rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T)))
    return x.astype(np.complex64), payload


def _match(tdem, jdem, what):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(tdem, f).numpy(),
                                      np.asarray(getattr(jdem, f)),
                                      err_msg=f"{what}:{f}")
    for f in CLOSE:
        np.testing.assert_allclose(getattr(tdem, f).numpy(),
                                   np.asarray(getattr(jdem, f)), atol=1e-3,
                                   err_msg=f"{what}:{f}")


@pytest.mark.parametrize("jfused", ["off", "interpret"])
@pytest.mark.parametrize("K", [2, 3])
def test_multiframe_matches_jax(K, jfused):
    rng = np.random.default_rng(40 + K)
    jcfg, tcfg = _cfgs(6, sf=7, cr="4/8")
    B = 5
    x, payload = _two_frame_bank(tcfg, rng, B, 6, 0.05)
    jdem = japi.demodulate(jnp.asarray(x), jcfg, max_frames=K, fused=jfused)
    for fused in ("off", "auto"):
        tdem = tapi.demodulate(torch.as_tensor(x), tcfg, max_frames=K,
                               fused=fused)
        assert tdem.found.shape == (B, K)
        assert tdem.symbols.shape == (B, K, tcfg.mtu)
        _match(tdem, jdem, fused)
    found = tdem.found.numpy()
    # both frames found in time order, the single frame once, noise never
    assert found[: B - 2, :2].all() and found[B - 2, 0]
    assert not found[B - 2, 1:].any() and not found[B - 1].any()
    assert (np.diff(tdem.t_sync.numpy()[: B - 2, :2], axis=1) > 0).all()
    got = tapi.extract_payloads(
        tapi.decode(tdem.symbols.reshape(B * K, -1), tcfg))
    for b in range(B - 2):
        for k in range(2):
            assert got[b * K + k] == bytes(payload[b, k].tolist()), (b, k)
    assert got[(B - 2) * K] == bytes(payload[B - 2, 0].tolist())


@pytest.mark.parametrize("option", ["debug", "spectra"])
def test_multiframe_taps_match_jax(option):
    rng = np.random.default_rng(50)
    jcfg, tcfg = _cfgs(6, sf=7, cr="4/6", crc_check=True)
    B, K = 4, 2
    x, payload = _two_frame_bank(tcfg, rng, B, 6, 0.05)
    kw = {option: True}
    jdem = japi.demodulate(jnp.asarray(x), jcfg, max_frames=K, fused="off",
                           **kw)
    for fused in ("off", "auto"):
        tdem = tapi.demodulate(torch.as_tensor(x), tcfg, max_frames=K,
                               fused=fused, **kw)
        _match(tdem, jdem, fused)
        want = np.asarray(jdem.fft_mag2)
        assert tdem.fft_mag2.shape == want.shape == (B, K, tcfg.mtu, tcfg.N)
        peak = want.max(-1, keepdims=True)
        assert (np.abs(tdem.fft_mag2.numpy() - want) <= 1e-4 * peak).all()
        if option == "debug":
            np.testing.assert_allclose(
                tdem.raw.numpy(),
                np.asarray(jdem.raw.re) + 1j * np.asarray(jdem.raw.im),
                atol=1e-6, rtol=0)
            assert tdem.dec.shape == (B, K, tcfg.mtu, tcfg.N)
        else:
            assert tdem.raw is None and tdem.dec is None
    soft = tapi.extract_payloads(
        tapi.decode_soft(tdem.fft_mag2.reshape(B * K, tcfg.mtu, tcfg.N), tcfg))
    for b in range(B - 2):
        for k in range(2):
            assert soft[b * K + k] == bytes(payload[b, k].tolist())


def test_max_frames_one_keeps_no_candidate_axis_and_bad_values_raise():
    _, tcfg = _cfgs(6, sf=7, cr="4/8")
    x = torch.zeros((2, tapi.required_samples(tcfg)), dtype=torch.complex64)
    assert tapi.demodulate(x, tcfg, max_frames=1).found.shape == (2,)
    assert tapi.demodulate(x[0], tcfg, max_frames=3).found.shape == (3,)
    with pytest.raises(ValueError, match="max_frames"):
        tapi.demodulate(x, tcfg, max_frames=0)


def test_plain_kernels_take_candidates():
    """track_plain and payload_detect_plain over [B, K] offsets equal K
    calls over [B] offsets: candidate (b, k) reads channel b."""
    rng = np.random.default_rng(60)
    _, tcfg = _cfgs(6, sf=7, cr="4/8")
    B, K, N = 3, 2, tcfg.N
    x, _ = _two_frame_bank(tcfg, rng, B + 2, 6, 0.05)
    x = torch.as_tensor(x[:B])
    T = x.shape[1]
    v, snr0, pwr = tdemod._coarse_detect(x, tcfg, False)
    _, t0, valid = tdemod._align_multi(v, snr0, pwr, tcfg, K, T)
    assert bool(valid.all())
    tr = cuda_demod.track_plain(x, t0, tcfg.sync, tcfg.thresh, N)
    assert bool(tr["synced"].all())
    ds = t0 + (tr["k_sync"] + 4) * N + N // 4
    out = cuda_demod.payload_detect_plain(x, ds, tr["fine_total"], tcfg.mtu,
                                          N, want_mag2=True)
    assert out[3].shape == (B, K, tcfg.mtu, N)
    for k in range(K):
        one = cuda_demod.track_plain(x, t0[:, k], tcfg.sync, tcfg.thresh, N)
        for name, val in one.items():
            assert torch.equal(val, tr[name][:, k]), name
        pk = cuda_demod.payload_detect_plain(
            x, ds[:, k], tr["fine_total"][:, k], tcfg.mtu, N, want_mag2=True)
        for a, b in zip(pk, out):
            assert torch.equal(a, b[:, k])
    # the wrappers refuse offsets that are not [B] or [B, K]
    for fn, args in ((cuda_demod.track_plain, (tcfg.sync, tcfg.thresh, N)),
                     (cuda_demod.payload_detect_plain,
                      (tr["fine_total"], tcfg.mtu, N))):
        with pytest.raises(ValueError, match="expected shape"):
            fn(x, t0[:2], *args)
