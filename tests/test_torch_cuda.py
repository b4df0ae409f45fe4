"""The port's three CUDA kernels against their plain PyTorch versions on the
card, at small shapes and at every window size the kernels take, plus the
whole demodulator on both routes.  Marked `cuda`: each test asks the `dev`
fixture for the card and skips without one (the kernels have no CPU mode).
The machine with the card has no jax, and tests/conftest.py imports it, so
run them there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Integer outputs must be equal; dB values, f_index and fine_total agree
within 1e-3 (float32 FFTs of another order).  The inputs are tones and
chirps with clear peaks, so no window sits on a near tie.
"""

import numpy as np
import pytest
import torch

import lora_tpu
from lora_tpu_torch import api
from lora_tpu_torch.models import demodulator as dm
from lora_tpu_torch.models import modulator as tmod
from lora_tpu_torch.ops import cuda_demod, cuda_detect, tables
from lora_tpu_torch.ops import detect as det_ops

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

TOL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


def tone_windows(rng, M, N, down):
    """M windows whose dechirped form is a tone at a random fractional bin,
    plus light noise, complex64 numpy."""
    bins = rng.integers(0, N, M) + rng.uniform(-0.3, 0.3, M)
    tone = np.exp(2j * np.pi * bins[:, None] * np.arange(N) / N)
    re, im = tables.dechirp_table_np(N, down)
    x = tone / (re + 1j * im)
    x += 0.05 * (rng.standard_normal((M, N)) + 1j * rng.standard_normal((M, N)))
    return x.astype(np.complex64)


def assert_detect_close(got, want, findex):
    assert torch.equal(got.value, want.value)
    for f in ("power", "noise") + (("f_index",) if findex else ()):
        d = (getattr(got, f) - getattr(want, f)).abs().max().item()
        assert d <= TOL, (f, d)


@pytest.mark.parametrize("N", [64, 128, 256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("mode", ["up", "up_fe", "down_fe"])
def test_detect_kernel_matches_plain(dev, N, mode):
    rng = np.random.default_rng(N)
    down = mode == "down_fe"
    M = 37  # a ragged last block at every team size
    x = torch.as_tensor(tone_windows(rng, M, N, down), device=dev)
    fe = (torch.as_tensor(rng.uniform(-1.5, 1.5, M).astype(np.float32),
                          device=dev) if mode != "up" else None)
    findex = mode != "down_fe"
    before = cuda_detect.dechirp_detect.launches
    got = cuda_detect.dechirp_detect(x, down, fe, want_f_index=findex)
    torch.cuda.synchronize()
    assert cuda_detect.dechirp_detect.launches == before + 1
    want = det_ops.dechirp_detect(x, down, fe, want_f_index=findex)
    assert_detect_close(got, want, findex)


def test_detect_kernel_reads_buffer_view(dev):
    """The coarse search's [B, W, N] view of [B, T] buffers (T not a
    multiple of N) is read in place, and gives what its copy gives."""
    rng = np.random.default_rng(3)
    B, W, N = 5, 9, 256
    x = tone_windows(rng, B * W, N, False).reshape(B, W * N)
    buf = torch.zeros((B, W * N + 77), dtype=torch.complex64, device=dev)
    buf[:, : W * N] = torch.as_tensor(x, device=dev)
    view = buf[:, : W * N].reshape(B, W, N)
    assert view.stride() == (W * N + 77, N, 1)
    got = cuda_detect.dechirp_detect(view, want_f_index=False)
    want = det_ops.dechirp_detect(view.contiguous(), want_f_index=False)
    assert got.value.shape == (B, W)
    assert_detect_close(got, want, False)


def _bank(cfg, rng, B, noise):
    """B buffers of required_samples: frames of random symbols at random
    delays with a CFO; the last channel is noise only."""
    N = cfg.N
    syms = torch.as_tensor(rng.integers(0, N, (B, cfg.mtu)))
    frames = tmod.modulate(syms, cfg).numpy()
    T = dm.required_samples(cfg)
    x = np.zeros((B, T), np.complex64)
    for b in range(B - 1):
        d = int(rng.integers(0, 3 * N))
        n = min(frames.shape[1], T - d)
        x[b, d : d + n] = frames[b, :n]
    cfo = rng.integers(-2, 3, (B, 1)) + rng.uniform(-0.4, 0.4, (B, 1))
    x *= np.exp(2j * np.pi * cfo * np.arange(T) / N)
    x += noise * (rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T)))
    return x.astype(np.complex64)


@pytest.mark.parametrize("sf", [6, 7, 10, 12])
def test_track_kernel_matches_plain(dev, sf):
    cfg = lora_tpu.LoRaConfig(sf=sf, cr="4/8", ampl=1.0, mtu=12)
    rng = np.random.default_rng(sf)
    x = torch.as_tensor(_bank(cfg, rng, 6, 0.2), device=dev)
    T = x.shape[1]
    v, snr0, pwr = dm._coarse_detect(x, cfg, False)
    _, t0, _ = dm._align_frame(v, snr0, pwr, cfg, T)
    # both ends of the range a caller may pass
    t0[-2] = 0
    t0[-1] = T - tables.TRACK_ROWS * cfg.N
    got = cuda_demod.track(x, t0, cfg.sync, cfg.thresh, cfg.N)
    want = cuda_demod.track_plain(x, t0, cfg.sync, cfg.thresh, cfg.N)
    assert bool(want["synced"][:3].all())
    for f in ("synced", "k_sync", "freq_error"):
        assert torch.equal(got[f], want[f]), f
    for f in ("fine_total", "power", "snr"):
        d = (got[f] - want[f]).abs().max().item()
        assert d <= TOL, (f, d)


@pytest.mark.parametrize("N,mtu", [(64, 9), (128, 20), (1024, 68), (4096, 7)])
def test_payload_kernel_matches_plain(dev, N, mtu):
    rng = np.random.default_rng(N + mtu)
    B, R = 7, mtu + 5
    T = R * N
    ds = rng.integers(0, T - (mtu + 1) * N + 1, B)
    ds[0], ds[1] = 0, T - (mtu + 1) * N  # both ends of the clamp range
    syms = torch.as_tensor(rng.integers(0, N, (B, mtu + 1)))
    cfg = lora_tpu.LoRaConfig(sf=N.bit_length() - 1)
    chirps = tmod.modulate(syms, cfg).numpy()[:, -((mtu + 1 + cfg.padding) * N):]
    x = np.zeros((B, T), np.complex64)
    for b in range(B):
        x[b, ds[b] : ds[b] + (mtu + 1) * N] = chirps[b, : (mtu + 1) * N]
    fe = rng.uniform(-0.45, 0.45, B).astype(np.float32)
    x *= np.exp(2j * np.pi * fe[:, None] * np.arange(T) / N)
    x += 0.05 * (rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T)))
    args = (torch.as_tensor(x.astype(np.complex64), device=dev),
            torch.as_tensor(ds, device=dev), torch.as_tensor(fe, device=dev),
            mtu, N)
    got = cuda_demod.payload_detect(*args)
    want = cuda_demod.payload_detect_plain(*args)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        d = (g - w).abs().max().item()
        assert d <= TOL, d


@pytest.mark.parametrize("sf,cr", [(7, "4/8"), (8, "4/5")])
def test_demodulate_routes_agree_on_card(dev, sf, cr):
    """fused='auto' (kernels A, B, C, one launch each) against fused='off'
    on the card: frame fields equal, payloads byte-exact."""
    cfg = lora_tpu.LoRaConfig(sf=sf, cr=cr, ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(10) + 4)
    rng = np.random.default_rng(sf)
    B = 8
    payload = rng.integers(0, 256, (B, 10)).astype(np.uint8)
    frames = api.modulate(api.encode(payload, cfg), cfg).numpy()
    T = api.required_samples(cfg)
    x = np.zeros((B, T), np.complex64)
    for b in range(B):
        d = int(rng.integers(0, 3 * cfg.N))
        x[b, d : d + frames.shape[1]] = frames[b, : T - d]
    x += 0.3 * (rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T)))
    xd = torch.as_tensor(x.astype(np.complex64), device=dev)
    wrappers = (cuda_detect.dechirp_detect, cuda_demod.track,
                cuda_demod.payload_detect)
    before = [w.launches for w in wrappers]
    auto = api.demodulate(xd, cfg, fused="auto")
    assert [w.launches - n for w, n in zip(wrappers, before)] == [1, 1, 1]
    off = api.demodulate(xd, cfg, fused="off")
    for f in ("found", "symbols", "count", "t_sync", "consumed", "freq_error",
              "payload_complete"):
        assert torch.equal(getattr(auto, f), getattr(off, f)), f
    for f in ("power", "snr", "fine_freq"):
        d = (getattr(auto, f) - getattr(off, f)).abs().max().item()
        assert d <= TOL, (f, d)
    got = api.extract_payloads(api.decode(auto.symbols, cfg))
    assert got == [bytes(p) for p in payload.tolist()]


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 1024), dtype=torch.complex64, device=dev)
    with pytest.raises(TypeError):
        cuda_detect.dechirp_detect(x.real.contiguous())
    with pytest.raises(ValueError):
        cuda_detect.dechirp_detect(torch.zeros((4, 100), dtype=torch.complex64,
                                               device=dev))
    t0 = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # shorter than the track's 18 windows
        cuda_demod.track(torch.zeros((4, 17 * 64), dtype=torch.complex64,
                                     device=dev), t0, 0x12, -10.0, 64)
    with pytest.raises(ValueError):  # one data_start per channel
        cuda_demod.payload_detect(x, t0[:3], torch.zeros(4, device=dev), 2, 64)
