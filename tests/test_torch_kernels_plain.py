"""The plain versions of the port's three CUDA kernels against every Pallas
entry point on the slice's path, run as tests/test_pallas_demod.py runs
them on the CPU (interpret mode).  Tolerances are that file's: values
exact, power within 2e-3 dB, noise within 2e-2 dB; f_index and fine_total
within 2e-3.

  kernel A  ops/detect.dechirp_detect      <- pallas_detect.dechirp_detect_pallas
  kernel B  ops/cuda_demod.track_plain     <- pallas_demod.track, track_direct
  kernel C  ops/cuda_demod.payload_detect_plain
                                 <- pallas_demod.payload_detect (flat, tiled),
                                    payload_detect_direct
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lora_tpu.ops import cplx as jcplx
from lora_tpu.ops import detect as jdet
from lora_tpu.ops import pallas_demod, pallas_detect
from lora_tpu.ops import shift as jshift

from lora_tpu_torch.models import demodulator as tdemod
from lora_tpu_torch.models import modulator as tmod
from lora_tpu_torch.ops import chirp, cuda_demod, cuda_detect, tables
from lora_tpu_torch.ops import detect as tdet

torch.set_num_threads(1)


def planar(x):
    return jcplx.IQ(jnp.asarray(x.real, jnp.float32),
                    jnp.asarray(x.imag, jnp.float32))


def assert_detect_close(got, want, findex=True):
    np.testing.assert_array_equal(got.value, np.asarray(want.value))
    np.testing.assert_allclose(got.power, np.asarray(want.power), atol=2e-3)
    np.testing.assert_allclose(got.noise, np.asarray(want.noise), atol=2e-2)
    if findex:
        np.testing.assert_allclose(got.f_index, np.asarray(want.f_index),
                                   atol=2e-3)


def chirp_stream(syms, N):
    """Phase-continuous up-chirps of the given symbols, complex64 numpy."""
    nums, carries = chirp.chirp_phase_nums(syms, N, N)
    starts = (torch.cumsum(carries, -1) - carries) & (N - 1)
    turns = ((nums + starts[..., None]) & (N - 1)).to(torch.float64) / N
    return np.exp(2j * np.pi * turns.numpy()).reshape(*syms.shape[:-1], -1)


# --------------------------------------------------------------------------
# kernel A
# --------------------------------------------------------------------------

@pytest.mark.parametrize("N", [128, 1024])
@pytest.mark.parametrize("down", [False, True])
@pytest.mark.parametrize("with_fe", [False, True])
def test_plain_detect_matches_pallas(N, down, with_fe):
    rng = np.random.default_rng(N + 2 * down + with_fe)
    M = 16
    # windows whose dechirped form is a tone at a random (fractional) bin
    bins = rng.integers(0, N, M) + rng.uniform(-0.3, 0.3, M)
    n = np.arange(N)
    tone = np.exp(2j * np.pi * bins[:, None] * n / N)
    re, im = tables.dechirp_table_np(N, down)
    x = tone / (re + 1j * im)
    x = (x + 0.05 * (rng.standard_normal((M, N))
                     + 1j * rng.standard_normal((M, N)))).astype(np.complex64)
    fe = rng.uniform(-1.5, 1.5, M).astype(np.float32) if with_fe else None
    got = tdet.dechirp_detect(torch.as_tensor(x), down,
                              None if fe is None else torch.as_tensor(fe))
    # the CPU route of the kernel's wrapper is this plain version
    routed = cuda_detect.dechirp_detect(torch.as_tensor(x), down,
                                        None if fe is None else
                                        torch.as_tensor(fe))
    np.testing.assert_array_equal(routed.value, got.value)
    jfe = None if fe is None else jnp.asarray(fe)
    pal = pallas_detect.dechirp_detect_pallas(planar(x), down, jfe,
                                              interpret=True)
    assert_detect_close(got, pal)
    xla = jdet.dechirp_detect(planar(x), down, jfe, fft_impl="xla")
    assert_detect_close(got, xla)


# --------------------------------------------------------------------------
# kernel B
# --------------------------------------------------------------------------

def _track_bank(rng, N, B, W):
    """B buffers of W rows: SF7 frames at random delays with CFO and noise,
    the last two channels noise only; t0 from the port's coarse search, as
    the demodulator aligns it."""
    import lora_tpu

    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/8", ampl=1.0, sync=0x34)
    syms = torch.as_tensor(rng.integers(0, N, (B, 4)))
    frames = tmod.modulate(syms, cfg, device="cpu").numpy()
    T = W * N
    x = np.zeros((B, T), np.complex64)
    delay = rng.integers(0, 3 * N, B)
    for b in range(B - 2):
        L = min(frames.shape[1], T - delay[b])
        x[b, delay[b] : delay[b] + L] = frames[b, :L]
    t = np.arange(T)
    x *= np.exp(2j * np.pi * rng.uniform(-2.3, 2.3, (B, 1)) * t / N)
    x += 0.2 * (rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T)))
    x = torch.as_tensor(x.astype(np.complex64))
    v, snr0, pwr = tdemod._coarse_detect(x, cfg, False)
    _, t0, _ = tdemod._align_frame(v, snr0, pwr, cfg, T)
    return cfg, x.numpy(), t0.numpy()


def _assert_track_close(got, want):
    for k in ("synced", "k_sync", "freq_error"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["fine_total"], np.asarray(want["fine_total"]),
                               atol=2e-3)
    np.testing.assert_allclose(got["power"], np.asarray(want["power"]),
                               atol=2e-3)
    np.testing.assert_allclose(got["snr"], np.asarray(want["snr"]), atol=2e-2)


@pytest.mark.parametrize("entry", ["track", "track_direct"])
def test_plain_track_matches_pallas(entry):
    N, B, W = 128, 8, 32
    R = tables.TRACK_ROWS
    rng = np.random.default_rng(7 if entry == "track" else 8)
    cfg, x, t0 = _track_bank(rng, N, B, W)
    thresh = -12.0
    q, rs = t0 // N, t0 % N
    if entry == "track":
        rows = jshift.gather_rows(planar(x), jnp.asarray(q), R, N)
        want = pallas_demod.track(rows, jnp.asarray(rs), cfg.sync, thresh,
                                  interpret=True)
    else:
        assert pallas_demod.track_direct_tc(N, W, B) is not None
        want = pallas_demod.track_direct(planar(x.reshape(B, W, N)),
                                         jnp.asarray(q), jnp.asarray(rs),
                                         cfg.sync, thresh, interpret=True)
    assert np.asarray(want["synced"])[: B - 2].all()
    got = cuda_demod.track_plain(torch.as_tensor(x), torch.as_tensor(t0),
                                 cfg.sync, thresh, N)
    _assert_track_close(got, want)
    routed = cuda_demod.track(torch.as_tensor(x), torch.as_tensor(t0),
                              cfg.sync, thresh, N)
    _assert_track_close(routed, want)


def test_plain_track_over_another_detector():
    """The scan calls its detector once per step on the step's window pair
    and once on the downchirp pair, with the CFO state it carries; kernel
    A's wrapper (the plain detector on the CPU) gives the same scan."""
    N, B, W = 128, 8, 32
    cfg, x, t0 = _track_bank(np.random.default_rng(9), N, B, W)
    x, t0 = torch.as_tensor(x), torch.as_tensor(t0)
    calls = []

    def detect(w, down=False, ferr=None, want_f_index=True):
        calls.append((tuple(w.shape), down, ferr.clone(), want_f_index))
        return tdet.dechirp_detect(w, down, ferr, want_f_index=want_f_index)

    want = cuda_demod.track_plain(x, t0, cfg.sync, -12.0, N)
    got = cuda_demod.track_plain(x, t0, cfg.sync, -12.0, N, detect=detect)
    routed = cuda_demod.track_plain(x, t0, cfg.sync, -12.0, N,
                                    detect=cuda_detect.dechirp_detect)
    for k, v in want.items():
        assert torch.equal(got[k], v) and torch.equal(routed[k], v), k
    assert len(calls) == tables.N_SCAN + 1
    assert all(c[:2] == ((B, 2, N), False) and c[3] for c in calls[:-1])
    assert calls[-1][1] and not calls[-1][3]
    assert torch.equal(calls[0][2], torch.zeros(B, 1))
    torch.testing.assert_close(calls[-1][2][:, 0],
                               want["fine_total"] - torch.div(
                                   want["freq_error"], 2,
                                   rounding_mode="trunc").float())


# --------------------------------------------------------------------------
# kernel C
# --------------------------------------------------------------------------

def _payload_rows(rng, N, mtu, B, R, q):
    """B buffers of R rows holding mtu+1 chirp symbols from row q[b] plus a
    random sub-window shift, with a CFO and noise."""
    T = R * N
    rs = rng.integers(0, N, B).astype(np.int32)
    ds = (q * N + rs).astype(np.int32)
    fe = rng.uniform(-0.45, 0.45, B).astype(np.float32)
    data = chirp_stream(torch.as_tensor(rng.integers(0, N, (B, mtu + 1))), N)
    x = np.zeros((B, T), np.complex64)
    for b in range(B):
        L = min(data.shape[1], T - ds[b])
        x[b, ds[b] : ds[b] + L] = data[b, :L]
    x *= np.exp(2j * np.pi * fe[:, None] * np.arange(T) / N)
    x += 0.05 * (rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T)))
    return x.astype(np.complex64), rs, fe, ds


@pytest.mark.parametrize(
    "route,N,mtu",
    [("flat", 128, 20), ("flat", 1024, 20), ("tiled", 512, 136),
     ("direct", 128, 20)],
)
def test_plain_payload_matches_pallas(route, N, mtu):
    rng = np.random.default_rng(N + mtu)
    if route == "tiled":
        # the tiled kernel, called directly as tests/test_pallas_demod.py
        # does (payload_detect routes this geometry to the flat kernel)
        B, rp = 2, pallas_demod.payload_geometry(N, mtu)[2]
    else:
        B, rp = 6, pallas_demod.payload_rows(N, mtu)
    if route == "direct":
        W = rp + 16
        assert pallas_demod.payload_direct_pc(N, mtu, W, B) is not None
        q = rng.integers(0, W - rp + 1, B)
        q[0], q[1] = 0, W - rp  # both ends of the clamp range
    else:
        W = rp
        q = np.zeros(B, np.int64)
    x, rs, fe, ds = _payload_rows(rng, N, mtu, B, W, q)
    g = planar(x.reshape(B, W, N))
    if route == "flat":
        want = pallas_demod.payload_detect(g, jnp.asarray(rs), jnp.asarray(fe),
                                           mtu, interpret=True)
    elif route == "tiled":
        want = pallas_demod._payload_tiled(g, jnp.asarray(rs), jnp.asarray(fe),
                                           mtu, interpret=True)
    else:
        want = pallas_demod.payload_detect_direct(
            g, jnp.asarray(q, jnp.int32), jnp.asarray(rs), jnp.asarray(fe),
            mtu, interpret=True)
    args = (torch.as_tensor(x), torch.as_tensor(ds), torch.as_tensor(fe),
            mtu, N)
    for got in (cuda_demod.payload_detect_plain(*args),
                cuda_demod.payload_detect(*args)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=2e-3)
        np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=2e-2)
