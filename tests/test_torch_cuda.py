"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes and at every window size or channel count the kernels
take, plus the demodulator and the channelized front end on both routes,
and the streaming runtime's device parts (the mirrored ring, the pinned
staging rule, streams through feed and pump, chunked resampling, the DC
blocker, slabs) against the same code on the CPU, the multi-device
paths on ranks that share the card against one process, and the captured
programs (utils/jit.py) against their calls under disable_jit().  Marked `cuda`: each
test asks the `dev` fixture for the card and skips without one (the
kernels have no CPU mode).  The `launches` fixture counts the kernels a
block launches from torch.profiler's record (utils/trace.launches).
The machine with the card has no jax, and tests/conftest.py imports it, so
run them there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Integer outputs must be equal; dB values, f_index and fine_total agree
within 1e-3 (float32 FFTs of another order).  The inputs are tones and
chirps with clear peaks, so no window sits on a near tie.  Kernel D's
channels agree with the plain block-Toeplitz product within 1e-4 of the
largest output (float32 sums in another order); its bf16 route (the
tensor cores' product) agrees with filterbank_fir_plain within the bars
stated there.
Kernel E is a copy: bit-equal.  Kernel C's mag2 agrees within 1e-4 of each
window's peak.
"""

import contextlib

import numpy as np
import pytest
import torch

import lora_tpu_torch
from lora_tpu_torch import api
from lora_tpu_torch.models import decoder as tdec
from lora_tpu_torch.models import demodulator as dm
from lora_tpu_torch.models import modulator as tmod
from lora_tpu_torch.ops import channelizer as chz
from lora_tpu_torch.ops import cuda_channelize, cuda_decode, cuda_demod
from lora_tpu_torch.ops import cuda_detect, tables
from lora_tpu_torch.ops import detect as det_ops
from lora_tpu_torch.ops import shift as shift_ops
from lora_tpu_torch.utils import trace
from test_torch_decode_model import CODES, FIELDS, FLAGS, decode_cases, flagged

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

TOL = 1e-3
D_RTOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def _counted():
    n = {}
    with trace.session() as prof:
        yield n
        torch.cuda.synchronize()
    n.update(trace.launches(prof))


@pytest.fixture
def launches(dev):
    """`with launches() as n:` fills n with the launches of each kernel
    family in the block (utils/trace.launches) when the block ends."""
    return _counted


def only(**counts) -> dict:
    """A launches record: these counts, and 0 for every other kernel."""
    return {**dict.fromkeys(trace.KERNELS + ("blocked",), 0), **counts}


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
def test_detect_kernel_matches_plain(dev, launches, N, mode):
    rng = np.random.default_rng(N)
    down = mode == "down_fe"
    M = 37  # a ragged last block at every team size
    x = torch.as_tensor(tone_windows(rng, M, N, down), device=dev)
    fe = (torch.as_tensor(rng.uniform(-1.5, 1.5, M).astype(np.float32),
                          device=dev) if mode != "up" else None)
    findex = mode != "down_fe"
    with launches() as n:
        got = cuda_detect.dechirp_detect(x, down, fe, want_f_index=findex)
    assert n == only(detect=1)
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


@pytest.mark.parametrize("n_cand", [1, 2])
@pytest.mark.parametrize("sf", [6, 7, 8, 9, 10, 11, 12])
def test_track_kernel_matches_plain(dev, launches, sf, n_cand):
    """Kernel B (one team a candidate, the lookahead only where the sync test
    reads it, the scan ended at the sync) against the plain scan of all 13
    window pairs, at every window size, with one and two candidates a
    channel, over a last block that is not full."""
    cfg = lora_tpu_torch.LoRaConfig(sf=sf, cr="4/8", ampl=1.0, mtu=12)
    rng = np.random.default_rng(sf)
    B = 9
    x = torch.as_tensor(_bank(cfg, rng, B, 0.2), device=dev)
    T = x.shape[1]
    hi = T - tables.TRACK_ROWS * cfg.N
    v, snr0, pwr = dm._coarse_detect(x, cfg, False)
    _, t0, _ = dm._align_frame(v, snr0, pwr, cfg, T)
    # both ends of the range a caller may pass
    t0[-3] = 0
    t0[-2] = hi
    if n_cand == 2:
        later = torch.as_tensor(rng.integers(0, hi + 1, B), device=dev,
                                dtype=t0.dtype)
        t0 = torch.stack([t0, later], 1)
    with launches() as n:
        got = cuda_demod.track(x, t0, cfg.sync, cfg.thresh, cfg.N)
    assert n == only(track=1)
    want = cuda_demod.track_plain(x, t0, cfg.sync, cfg.thresh, cfg.N)
    assert bool(want["synced"].reshape(B, -1)[:5, 0].all())
    assert not bool(want["synced"].reshape(B, -1)[-1, 0])  # noise only
    for f in ("synced", "k_sync", "freq_error"):
        assert got[f].shape == t0.shape and torch.equal(got[f], want[f]), f
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
    cfg = lora_tpu_torch.LoRaConfig(sf=N.bit_length() - 1)
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
def test_demodulate_routes_agree_on_card(dev, launches, sf, cr):
    """fused='auto' (kernels A, B, C, one launch each) against fused='off'
    on the card: frame fields equal, payloads byte-exact."""
    cfg = lora_tpu_torch.LoRaConfig(sf=sf, cr=cr, ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(10) + 4)
    rng = np.random.default_rng(sf)
    B = 8
    payload = rng.integers(0, 256, (B, 10)).astype(np.uint8)
    frames = api.modulate(api.encode(payload, cfg, device="cpu"), cfg).numpy()
    T = api.required_samples(cfg)
    x = np.zeros((B, T), np.complex64)
    for b in range(B):
        d = int(rng.integers(0, 3 * cfg.N))
        x[b, d : d + frames.shape[1]] = frames[b, : T - d]
    x += 0.3 * (rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T)))
    xd = torch.as_tensor(x.astype(np.complex64), device=dev)
    with launches() as n:
        auto = api.demodulate(xd, cfg, fused="auto")
    assert n == only(detect=1, track=1, payload=1)
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


def crandn(rng, shape, dev):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.as_tensor(x.astype(np.complex64), device=dev)


def fenced(t, offset):
    """A copy of t [S, n] inside an allocation that is NaN wherever t is not:
    `offset` samples before the first row (so the rows are 8-byte aligned
    only when it is odd), one NaN between rows, and nothing after the last
    row, which ends the allocation."""
    S, n = t.shape
    base = torch.full((offset + S * (n + 1) - 1,), float("nan"),
                      dtype=t.dtype, device=t.device)
    view = base[offset:].as_strided((S, n), (n + 1, 1))
    view.copy_(t)
    return view


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("K", [8, 16, 24, 32, 64, 128, 192, 256, 512, 1024])
@pytest.mark.parametrize("L", [4, 8, 12])
def test_channelize_kernel_matches_plain(dev, launches, K, L, with_state):
    """Kernel D against the plain product, with a random state and with none
    (a null history pointer), over tile seams and a ragged last tile, for one
    and three streams.  History and block are strided views into NaN-filled
    allocations that end with their last row: a read outside them shows in
    the output."""
    rng = np.random.default_rng(K * 100 + L)
    M = 517  # odd: no tile of any width divides it
    for S in (1, 3):
        x = fenced(crandn(rng, (S, K * M), dev), S)
        st = fenced(crandn(rng, (S, L * K - 1), dev), 1) if with_state else None
        with launches() as n:
            y, s = chz.channelize(x, K, L, state=st)
        assert n == only(channelize=1)
        yp, sp = chz.channelize(x.contiguous(), K, L,
                                state=None if st is None else st.contiguous(),
                                impl="xla")
        assert y.shape == (S, K, M) and y.is_contiguous()
        assert torch.equal(s, sp)
        assert bool(torch.isfinite(torch.view_as_real(y)).all())
        err = (y - yp).abs().max().item()
        assert err <= D_RTOL * yp.abs().max().item(), (S, err)


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("S,M", [(2, 12288), (2, 65536), (1, 3229), (3, 3229)])
def test_channelize_kernel_at_the_cells_widths_matches_plain(dev, launches, S,
                                                            M, with_state):
    """Kernel D's route 1 at the wideband cells' K = 64, L = 8 against the
    plain product: two streams of each cell's M (12,288 and 65,536), and
    101 tiles with a ragged last one over one and three streams; with a
    state and with none, on fenced NaN-filled strided views.  The same block
    contiguous gives the same bits."""
    rng = np.random.default_rng(M + 10 * S + with_state)
    K, L = 64, 8
    x = fenced(crandn(rng, (S, K * M), dev), S)
    st = fenced(crandn(rng, (S, L * K - 1), dev), 1) if with_state else None
    with launches() as n:
        y, s = chz.channelize(x, K, L, state=st)
    assert n == only(channelize=1)
    assert torch.equal(y, chz.channelize(x.contiguous(), K, L, state=st)[0])
    yp, sp = chz.channelize(x.contiguous(), K, L,
                            state=None if st is None else st.contiguous(),
                            impl="xla")
    assert y.shape == (S, K, M) and y.is_contiguous()
    assert torch.equal(s, sp)
    assert bool(torch.isfinite(torch.view_as_real(y)).all())
    err = (y - yp).abs().max().item()
    assert err <= D_RTOL * yp.abs().max().item(), err


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("K,L", [(1024, 20), (512, 40), (256, 81)])
def test_channelize_long_filters_match_plain(dev, launches, K, L, with_state):
    """Route 1 at the widest banks with the longest filter each takes (its
    staged rows fill shared memory), against the plain product on fenced
    views, for one and three streams."""
    assert cuda_channelize.route(K, L) == 1
    rng = np.random.default_rng(K + L)
    M = 37  # odd: a ragged last tile
    for S in (1, 3):
        x = fenced(crandn(rng, (S, K * M), dev), S)
        st = fenced(crandn(rng, (S, L * K - 1), dev), 1) if with_state else None
        with launches() as n:
            y, s = chz.channelize(x, K, L, state=st)
        assert n == only(channelize=1)
        yp, sp = chz.channelize(x.contiguous(), K, L,
                                state=None if st is None else st.contiguous(),
                                impl="xla")
        assert torch.equal(s, sp)
        assert bool(torch.isfinite(torch.view_as_real(y)).all())
        err = (y - yp).abs().max().item()
        assert err <= D_RTOL * yp.abs().max().item(), (S, err)


def direct_tile(K, L):
    """channelize.cu direct_tile: route 2's tile for (K, L), 0 where none
    fits (the bf16 flag took route 2 at every such K before route 3)."""
    threads, mb, kb, max_smem = 256, 2, 8, 232448
    smem = lambda TM: 8 * (K + (TM + L - 1) * (K + 1) + K * TM)
    TM = 64
    while TM < mb * threads and threads * mb // TM > -(-K // kb):
        TM *= 2
    while TM > 32 and smem(TM) > max_smem // 2:
        TM //= 2
    while TM > mb and smem(TM) > max_smem:
        TM //= 2
    return TM if smem(TM) <= max_smem else 0


def test_channelize_tile_fits_every_width(dev):
    """The kernel's own choice of route: the register FFT for the powers of
    two from 8 to 1024, the direct sum for every other width up to 1024;
    none for 4096.  bf16 takes route 3 at every width the direct sum took
    for it before, and up to K = 7,248 at any L."""
    for L in (4, 8, 12):
        for K in range(8, 1025, 8):
            want = 1 if K & (K - 1) == 0 else 2
            assert cuda_channelize.route(K, L) == want, (K, L)
    assert cuda_channelize.route(24, 8) == 2
    with pytest.raises(ValueError, match="no tile fits"):
        cuda_channelize.route(4096, 8)
    for L, step in ((8, 1), (1, 7), (4, 7), (12, 7)):
        served = [K for K in range(1, 6000, step) if direct_tile(K, L)]
        assert served and served[-1] > 1000
        for K in served:
            assert cuda_channelize.route(K, L, bf16=True) == 3, (K, L)
    assert cuda_channelize.route(7248, 8, bf16=True) == 3
    with pytest.raises(ValueError, match="no tile fits"):
        cuda_channelize.route(7249, 8, bf16=True)


# kernel D's bf16 route against filterbank_fir_plain: the FIR
# output may differ by a float32 step (fused multiply-adds), and then its
# bfloat16 rounding by one bfloat16 step: on at least 99% of the samples
# within 1e-5 of the peak, everywhere within 1e-2
# (tests/test_torch_channelizer.py, BF16_FIR_*).  Against the float32
# kernel: lora_tpu's bf16 bar, 3e-2 absolute on unit-variance noise.
BF16_FIR_RTOL, BF16_FIR_SHARE, BF16_FIR_MAX_RTOL = 1e-5, 0.99, 1e-2
BF16_KERNEL_ATOL = 3e-2


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("K", [8, 12, 16, 24, 40, 64, 128, 192, 1024, 2048])
def test_channelize_bf16_kernel_matches_plain(dev, launches, K, with_state):
    """Kernel D's bf16 route (route 3, the IDFT on the tensor cores, at
    every K: padded at 8, 12, 24, 40) against its plain version on fenced
    views, one launch; and against the float32 kernel."""
    rng = np.random.default_rng(K * 10 + with_state)
    L, M, S = 8, 517, 2
    x = fenced(crandn(rng, (S, K * M), dev), S)
    st = fenced(crandn(rng, (S, L * K - 1), dev), 1) if with_state else None
    with launches() as n:
        y, s = chz.channelize(x, K, L, state=st, bf16=True)
    assert n == only(channelize=1)
    xp = chz.prepended(x.contiguous(),
                       None if st is None else st.contiguous(), L * K - 1)
    want = cuda_channelize.filterbank_fir_plain(xp, K, L, M)
    assert y.shape == (S, K, M) and y.is_contiguous()
    assert torch.equal(s, chz.channelize(x, K, L, state=st)[1])
    d = (y - want).abs() / want.abs().max()
    assert (d <= BF16_FIR_RTOL).float().mean().item() >= BF16_FIR_SHARE
    assert d.max().item() <= BF16_FIR_MAX_RTOL
    f32, _ = chz.channelize(x, K, L, state=st)
    err = torch.view_as_real(y - f32).abs().max().item()
    assert err < BF16_KERNEL_ATOL, err


def test_channelize_kernel_takes_views_and_refuses_the_rest(dev):
    """A block whose last axis is strided is made contiguous; a state of
    another shape, type or device raises."""
    rng = np.random.default_rng(12)
    K, L, M = 64, 8, 40
    x = crandn(rng, (2, K * M, 2), dev)[..., 0]
    st = crandn(rng, (2, L * K - 1), dev)
    assert x.stride(-1) == 2
    y = cuda_channelize.filterbank(x, K, L, st)
    want = cuda_channelize.filterbank(x.contiguous(), K, L, st)
    assert torch.equal(y, want)
    with pytest.raises(ValueError, match="state of shape"):
        cuda_channelize.filterbank(x, K, L, st[:, :-1])
    with pytest.raises(TypeError):
        cuda_channelize.filterbank(x, K, L, st.to(torch.complex128))
    with pytest.raises(ValueError, match="state on"):
        cuda_channelize.filterbank(x, K, L, st.cpu())


def test_channelize_kernel_streaming_continuity(dev):
    """Two chunks through the kernel with carried state (the second reads
    the first's tail through the history pointer) equal one shot."""
    rng = np.random.default_rng(9)
    K, M = 64, 200
    x = crandn(rng, (2, K * M), dev)
    y_full, s_full = chz.channelize(x, K)
    y1, st = chz.channelize(x[:, : K * M // 2], K)
    y2, s2 = chz.channelize(x[:, K * M // 2 :], K, state=st)
    assert (torch.cat([y1, y2], -1) - y_full).abs().max().item() <= 1e-6
    assert torch.equal(s2, s_full)


def test_channelized_demodulate_routes_agree_on_card(dev, launches):
    """fused='auto' (kernels D, A, B, C, one launch each) against
    fused='off' on a 16-channel grid with a frame on every even channel:
    frame fields equal, payloads byte-exact."""
    rng = np.random.default_rng(10)
    K = 16
    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 2)
    N, M = cfg.N, api.required_samples(cfg)
    S = 2
    payload = rng.integers(0, 256, (S, K // 2, 16)).astype(np.uint8)
    frames = api.modulate(api.encode(payload.reshape(-1, 16), cfg,
                                     device="cpu"), cfg)
    frames = frames.numpy().reshape(S, K // 2, -1)
    u = np.zeros((S, K, M), np.complex64)
    for s in range(S):
        for i in range(K // 2):
            d = int(rng.integers(0, N))
            u[s, 2 * i, d : d + frames.shape[-1]] = frames[s, i, : M - d]
    cfo = rng.integers(-2, 3, (S, K, 1)) + rng.uniform(-0.4, 0.4, (S, K, 1))
    u *= np.exp(2j * np.pi * cfo * np.arange(M) / N)
    wide, _ = chz.synthesize(torch.as_tensor(u, device=dev))
    wide = wide + 0.01 * crandn(rng, wide.shape, dev)
    with launches() as n:
        auto, _ = api.channelized_demodulate(wide, K, cfg, fused="auto")
    assert n == only(channelize=1, detect=1, track=1, payload=1)
    off, _ = api.channelized_demodulate(wide, K, cfg, fused="off")
    assert auto.found.shape == (S, K)
    assert bool(auto.found[:, 0::2].all())
    for f in ("found", "symbols", "count", "t_sync", "consumed", "freq_error",
              "payload_complete"):
        assert torch.equal(getattr(auto, f), getattr(off, f)), f
    for f in ("power", "snr", "fine_freq"):
        d = (getattr(auto, f) - getattr(off, f)).abs().max().item()
        assert d <= TOL, (f, d)
    got = api.extract_payloads(api.decode(auto.symbols.reshape(-1, cfg.mtu),
                                          cfg))
    assert got == api.extract_payloads(
        api.decode(off.symbols.reshape(-1, cfg.mtu), cfg))
    for s in range(S):
        for i in range(K // 2):
            assert got[s * K + 2 * i] == bytes(payload[s, i]), (s, i)


def test_out_of_slice_options_raise_on_card(dev, launches):
    """The interpret routes raise; the channelizer's bf16 contraction runs
    kernel D's bf16 route (one launch), under channelized_demodulate too."""
    cfg = lora_tpu_torch.LoRaConfig(sf=7, mtu=8)
    wide = torch.zeros((1, 16 * api.required_samples(cfg)),
                       dtype=torch.complex64, device=dev)
    for fused in ("interpret", "interpret-bf16"):
        with pytest.raises(NotImplementedError, match="no CUDA counterpart"):
            api.channelized_demodulate(wide, 16, cfg, fused=fused)
    for impl in ("fir-interpret", "pallas-interpret"):
        with pytest.raises(NotImplementedError, match="no CUDA counterpart"):
            chz.channelize(wide, 16, impl=impl)
    with launches() as n:
        y, _ = chz.channelize(wide, 16, bf16=True)
        dem, _ = api.channelized_demodulate(wide, 16, cfg, fused="bf16")
    assert n["channelize"] == 2
    assert not bool(y.any()) and not bool(dem.found.any())
    # fused="bf16" is "auto": the kernels run
    with launches() as n:
        dec, _ = api.loopback(np.arange(4, dtype=np.uint8),
                              cfg.replace(mtu=cfg.num_symbols(4)),
                              fused="bf16", device=dev)
    assert n["detect"] == 1
    assert api.extract_payloads(dec) == [bytes(range(4))]
    # a width kernel D does not take raises; it never takes the plain route
    with pytest.raises(ValueError, match="no tile fits"):
        chz.channelize(torch.zeros((1, 4096 * 4), dtype=torch.complex64,
                                   device=dev), 4096)
    with pytest.raises(TypeError):
        cuda_channelize.filterbank(wide.real.contiguous(), 16, 8)
    with pytest.raises(ValueError):  # a block that is no multiple of K
        cuda_channelize.filterbank(wide[:, :100], 16, 8)


# --------------------------------------------------------------------------
# the receive options: kernel E, kernel C's mag2, K candidates, host data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(9,), (4, 3)])
@pytest.mark.parametrize("N,R,mtu", [(128, 9, 8), (1024, 18, 17),
                                     (4096, 6, 5), (1024, 70, 68)])
def test_shift_kernel_bit_equal(dev, launches, N, R, mtu, lead):
    rng = np.random.default_rng(N + R)
    g = crandn(rng, (*lead, R, N), dev)
    r = rng.integers(0, N, lead)
    r.reshape(-1)[:4] = (0, 1, N - 2, N - 1)  # even and odd, both ends
    r = torch.as_tensor(r, device=dev)
    with launches() as n:
        got = shift_ops.shift_windows(g, r, mtu)
    assert n == only(shift=1)
    assert got.shape == (*lead, mtu, N)
    assert torch.equal(got, shift_ops.shift_windows_plain(g, r, mtu))
    # rows of a larger buffer: a channel stride above R * N
    wide = crandn(rng, (*lead, R + 3, N), dev)
    view = wide[..., :R, :]
    assert torch.equal(shift_ops.shift_windows(view, r, mtu),
                       shift_ops.shift_windows_plain(view, r, mtu))


def test_shift_kernel_refusals(dev):
    g = torch.zeros((2, 5, 64), dtype=torch.complex64, device=dev)
    r = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="rows < mtu"):
        shift_ops.shift_windows(g, r, 5)
    with pytest.raises(ValueError, match="expected"):
        shift_ops.shift_windows(g, r + 64, 4)
    with pytest.raises(TypeError, match="complex64"):
        shift_ops.shift_windows(g.to(torch.complex128), r, 4)
    with pytest.raises(ValueError, match="contiguous rows"):
        shift_ops.shift_windows(g.transpose(1, 2).contiguous().transpose(1, 2),
                                r, 4)
    with pytest.raises(ValueError, match="16-byte"):  # an odd sample offset
        base = torch.zeros(2 * 5 * 64 + 1, dtype=torch.complex64, device=dev)
        shift_ops.shift_windows(base[1:].reshape(2, 5, 64), r, 4)


def _payload_args(rng, dev, N, mtu, lead):
    """Buffers of chirps with clear peaks, data starts and fine CFOs of
    shape `lead` ([B] or [B, K])."""
    B = lead[0]
    T = (mtu + 6) * N
    sf = N.bit_length() - 1
    cfg = lora_tpu_torch.LoRaConfig(sf=sf)
    syms = torch.as_tensor(rng.integers(0, N, (B, mtu + 5)))
    chirps = tmod.modulate(syms, cfg).numpy()
    x = chirps[:, -T:] if chirps.shape[1] >= T else np.pad(
        chirps, ((0, 0), (0, T - chirps.shape[1])))
    x = x + 0.05 * (rng.standard_normal((B, T))
                    + 1j * rng.standard_normal((B, T)))
    ds = rng.integers(0, T - (mtu + 1) * N + 1, lead)
    fe = rng.uniform(-0.45, 0.45, lead).astype(np.float32)
    return (torch.as_tensor(x.astype(np.complex64), device=dev),
            torch.as_tensor(ds, device=dev), torch.as_tensor(fe, device=dev),
            mtu, N)


@pytest.mark.parametrize("N", [64, 128, 256, 512, 1024, 2048, 4096])
def test_payload_kernel_mag2(dev, N):
    rng = np.random.default_rng(N)
    mtu = 9
    args = _payload_args(rng, dev, N, mtu, (5,))
    got = cuda_demod.payload_detect(*args, want_mag2=True)
    want = cuda_demod.payload_detect_plain(*args, want_mag2=True)
    bare = cuda_demod.payload_detect(*args)
    assert len(got) == 4 and len(bare) == 3
    assert got[3].shape == (5, mtu, N) and got[3].dtype == torch.float32
    for g, b in zip(got, bare):  # the mag2 output changes nothing else
        assert torch.equal(g, b)
    assert torch.equal(got[0], want[0])
    peak = want[3].amax(-1, keepdim=True)
    assert bool(((got[3] - want[3]).abs() <= 1e-4 * peak).all())
    # value is the lowest bin of the largest mag2 written
    top = got[3].amax(-1, keepdim=True)
    first = (got[3] == top).to(torch.int8).argmax(-1)
    assert torch.equal(first, got[0].long())


@pytest.mark.parametrize("N", [128, 1024, 2048])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_windows_abut_the_end_of_the_buffer(dev, launches, N, offset):
    """Kernels A and C over buffers that start `offset` samples into an
    allocation (odd: 8-byte aligned only) and whose last window ends with
    it: every sample around the buffers is NaN, so a read outside them shows
    in the outputs."""
    rng = np.random.default_rng(N + offset)
    B, W, mtu = 3, 5, 4
    x = torch.as_tensor(tone_windows(rng, B * W, N, False), device=dev)
    base = torch.full((offset + B * W * N,), float("nan"),
                      dtype=torch.complex64, device=dev)
    base[offset:] = x.reshape(-1)
    view = base[offset:].reshape(B, W, N)
    with launches() as n:
        got = cuda_detect.dechirp_detect(view)
    assert n == only(detect=1)
    assert_detect_close(got, det_ops.dechirp_detect(x.reshape(B, W, N)), True)

    # kernel C: rows of T samples, the last channel's windows at the row's
    # end; T - mtu*N is odd or even with `offset`, the rows alternate.  The
    # plain version cuts mtu + 1 rows, so it gets a row of zeros more.
    T = (mtu + 1) * N + 1 + offset
    args = list(_payload_args(rng, dev, N, mtu, (B,)))
    rows = args[0][:, :T]
    base = torch.full((offset + B * T,), float("nan"), dtype=torch.complex64,
                      device=dev)
    base[offset:] = rows.reshape(-1)
    args[0] = base[offset:].reshape(B, T)
    args[1] = torch.as_tensor([0, 1, T - mtu * N], device=dev)
    for want_mag2 in (False, True):
        got = cuda_demod.payload_detect(*args, want_mag2=want_mag2)
        want = cuda_demod.payload_detect_plain(
            torch.nn.functional.pad(rows, (0, N)), *args[1:],
            want_mag2=want_mag2)
        assert torch.equal(got[0], want[0])
        for g, w in zip(got[1:3], want[1:3]):
            assert (g - w).abs().max().item() <= TOL
        if want_mag2:
            peak = want[3].amax(-1, keepdim=True)
            assert bool(((got[3] - want[3]).abs() <= 1e-4 * peak).all())


@pytest.mark.parametrize("N", [2048, 4096])
def test_payload_mag2_over_many_windows_of_large_teams(dev, N):
    """N = 2048 and 4096 (teams of two and four warps, three passes) with
    mag2 over more windows than the card holds teams at once, so every team
    walks over several windows and reuses its exchange buffer."""
    rng = np.random.default_rng(N)
    B, mtu = 96, 24
    args = _payload_args(rng, dev, N, mtu, (B,))
    got = cuda_demod.payload_detect(*args, want_mag2=True)
    want = cuda_demod.payload_detect_plain(*args, want_mag2=True)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:3], want[1:3]):
        assert (g - w).abs().max().item() <= TOL
    peak = want[3].amax(-1, keepdim=True)
    assert bool(((got[3] - want[3]).abs() <= 1e-4 * peak).all())
    first = (got[3] == got[3].amax(-1, keepdim=True)).to(torch.int8).argmax(-1)
    assert torch.equal(first, got[0].long())


@pytest.mark.parametrize("want_mag2", [False, True])
def test_kernels_take_k_candidates(dev, launches, want_mag2):
    """Kernels B and C over [B, K] offsets equal K launches over [B]
    offsets: candidate (b, k) reads channel b of the same buffers."""
    rng = np.random.default_rng(3)
    B, K, N, mtu = 4, 3, 256, 10
    args = _payload_args(rng, dev, N, mtu, (B, K))
    x, ds, fe = args[:3]
    with launches() as n:
        got = cuda_demod.payload_detect(*args, want_mag2=want_mag2)
    assert n == only(payload=1)
    want = cuda_demod.payload_detect_plain(*args, want_mag2=want_mag2)
    assert got[0].shape == (B, K, mtu)
    assert torch.equal(got[0], want[0])
    for k in range(K):
        one = cuda_demod.payload_detect(x, ds[:, k].contiguous(),
                                        fe[:, k].contiguous(), mtu, N,
                                        want_mag2=want_mag2)
        for a, b in zip(one, got):
            assert torch.equal(a, b[:, k])
    if want_mag2:
        return
    cfg = lora_tpu_torch.LoRaConfig(sf=8, cr="4/8", ampl=1.0, mtu=12)
    xb = torch.as_tensor(_bank(cfg, rng, B, 0.2), device=dev)
    T = xb.shape[1]
    t0 = torch.as_tensor(
        rng.integers(0, T - tables.TRACK_ROWS * cfg.N, (B, K)), device=dev)
    v, snr0, pwr = dm._coarse_detect(xb, cfg, False)
    t0[:, 0] = dm._align_frame(v, snr0, pwr, cfg, T)[1]
    with launches() as n:
        got = cuda_demod.track(xb, t0, cfg.sync, cfg.thresh, cfg.N)
    assert n == only(track=1)
    want = cuda_demod.track_plain(xb, t0, cfg.sync, cfg.thresh, cfg.N)
    assert bool(got["synced"][: B - 1, 0].all())
    for k in range(K):
        one = cuda_demod.track(xb, t0[:, k].contiguous(), cfg.sync,
                               cfg.thresh, cfg.N)
        for f, val in one.items():
            assert val.shape == (B,) and torch.equal(val, got[f][:, k]), f
    for f in ("synced", "k_sync", "freq_error"):
        assert torch.equal(got[f], want[f]), f
    for f in ("fine_total", "power", "snr"):
        assert (got[f] - want[f]).abs().max().item() <= TOL, f


def _two_frames(cfg, rng, B, L):
    payload = rng.integers(0, 256, (B, 2, L)).astype(np.uint8)
    frames = api.modulate(api.encode(payload.reshape(2 * B, L), cfg,
                                     device="cpu"), cfg).numpy()
    frames = frames.reshape(B, 2, -1)
    F, N = frames.shape[-1], cfg.N
    x = np.zeros((B, 2 * api.required_samples(cfg)), np.complex64)
    for b in range(B):
        d0 = int(rng.integers(0, 2 * N))
        d1 = d0 + F + int(rng.integers(2 * N, 4 * N))
        x[b, d0 : d0 + F] += frames[b, 0]
        x[b, d1 : d1 + F] += 0.5 * frames[b, 1]
    x += 0.05 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64), payload


@pytest.mark.parametrize("option", ["plain", "debug", "spectra"])
def test_receive_options_routes_agree_on_card(dev, launches, option):
    """max_frames=2 with and without the taps: fused='auto' against 'off'
    on the card, one launch of each kernel on the route's path."""
    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/8", ampl=1.0, crc_check=True)
    cfg = cfg.replace(mtu=cfg.num_symbols(6))
    rng = np.random.default_rng(5)
    B = 6
    x, payload = _two_frames(cfg, rng, B, 6)
    kw = {} if option == "plain" else {option: True}
    with launches() as n:
        auto = api.demodulate(x, cfg, max_frames=2, fused="auto", device=dev,
                              **kw)
    assert auto.found.device.type == dev.type  # host data went to `dev`
    assert n == (only(detect=1, track=1, shift=1) if option == "debug"
                 else only(detect=1, track=1, payload=1))
    off = api.demodulate(torch.as_tensor(x, device=dev), cfg, max_frames=2,
                         fused="off", **kw)
    for f in ("found", "symbols", "count", "t_sync", "consumed", "freq_error"):
        assert torch.equal(getattr(auto, f), getattr(off, f)), f
    assert bool(auto.found.all())
    want = [bytes(p) for p in payload.reshape(2 * B, -1).tolist()]
    hard = api.decode(auto.symbols.reshape(2 * B, -1), cfg)
    assert api.extract_payloads(hard) == want
    if option == "plain":
        assert auto.fft_mag2 is None
        return
    peak = off.fft_mag2.amax(-1, keepdim=True)
    assert bool(((auto.fft_mag2 - off.fft_mag2).abs() <= 1e-4 * peak).all())
    soft = api.decode_soft(auto.fft_mag2.reshape(2 * B, cfg.mtu, cfg.N), cfg)
    assert api.extract_payloads(soft) == want
    if option == "debug":
        assert torch.equal(auto.raw, off.raw)
        peak = off.dec.abs().amax(-1, keepdim=True)
        assert bool(((auto.dec - off.dec).abs() <= 1e-4 * peak).all())


def test_trace_profile_keeps_every_kernel_of_one_call(dev, tmp_path):
    """utils.trace.profile around one demodulate on the card writes a
    Chrome trace that names kernels A, B and C once each, after the
    launches that open the session to take torch.profiler's drop of a
    session's first device records (some of them left)."""
    import json

    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/8", ampl=1.0, crc_check=True)
    cfg = cfg.replace(mtu=cfg.num_symbols(6))
    x, _ = _two_frames(cfg, np.random.default_rng(6), 6, 6)
    x = torch.as_tensor(x, device=dev)
    api.demodulate(x, cfg)
    torch.cuda.synchronize()
    with trace.profile(str(tmp_path)):
        dem = api.demodulate(x, cfg)
        torch.cuda.synchronize()
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "kernel"]
    assert [sum(f"{k}_kernel" in n for n in names)
            for k in ("detect", "track", "payload")] == [1, 1, 1]
    assert 0 < sum(trace.ABSORB_KERNEL in n for n in names) <= trace.ABSORB
    assert bool(dem.found.any())


def test_program_spans_hold_the_decode_graphs_launch(dev, tmp_path):
    """One traced demodulate and decode of a small bank on the card through
    utils.trace.session: decode runs no captured program (no
    lora.program:_decode span), and inside lora.decode lies exactly one
    launch of kernel G, whose kernel carries that launch's correlation id;
    device_ms.decode's rule (phybench/metrics) on that trace reads that
    kernel's device time; the record holds the replayed graph's kernels A,
    B, C and kernel G, one launch each."""
    import json

    from phybench import harness
    from phybench.trace import Trace

    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/8", ampl=1.0, crc_check=True)
    cfg = cfg.replace(mtu=cfg.num_symbols(6))
    x, _ = _two_frames(cfg, np.random.default_rng(7), 6, 6)
    x = torch.as_tensor(x, device=dev)
    for _ in range(2):  # the demodulator captured, then replayed
        api.decode(api.demodulate(x, cfg).symbols, cfg)
    torch.cuda.synchronize()
    with trace.session() as prof:
        api.decode(api.demodulate(x, cfg).symbols, cfg)
        torch.cuda.synchronize()
    assert trace.launches(prof) == only(detect=1, track=1, payload=1,
                                        decode=1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]

    def spans(name):
        return [e for e in events if e.get("cat") == "user_annotation"
                and e["name"] == name]

    def inside(e, s):
        return (e.get("tid") == s.get("tid") and s["ts"] - 1e-3 <= e["ts"]
                and e["ts"] + e["dur"] <= s["ts"] + s["dur"] + 1e-3)

    calls = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver")
             and "correlation" in e.get("args", {})]
    (dec,) = spans("lora.decode")
    assert not spans("lora.program:_decode")
    assert not [s for s in events if s.get("cat") == "user_annotation"
                and s["name"].startswith("lora.program") and inside(s, dec)]
    ids = {e["args"]["correlation"] for e in calls if inside(e, dec)}
    launched = [e for e in events if e.get("cat") == "kernel"
                and e["args"].get("correlation") in ids]
    (kernel,) = launched
    assert "decode_kernel" in kernel["name"]
    tr = Trace(events)
    want = sum(e["dur"] for e in tr.device
               if e["args"].get("correlation") in ids) * 1e-3
    got = harness.reader("device_ms.decode")(harness.Reading(tr, {}))
    assert got == pytest.approx(want)
    assert want == pytest.approx(kernel["dur"] * 1e-3) and want > 0


def test_host_data_lands_on_the_card(dev):
    """device=None means the card in every entry point that takes host
    data; a tensor stays where its caller put it."""
    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/8", ampl=1.0, crc_check=True)
    cfg = cfg.replace(mtu=cfg.num_symbols(4))
    payload = np.arange(4, dtype=np.uint8)[None]
    sym = api.encode(payload, cfg)
    assert sym.is_cuda
    iq = api.modulate(sym.cpu().numpy(), cfg)
    assert iq.is_cuda
    dem = api.demodulate(iq.cpu().numpy(), cfg, spectra=True)
    assert dem.symbols.is_cuda and dem.fft_mag2.is_cuda
    assert api.decode(dem.symbols.cpu().numpy(), cfg).data.is_cuda
    assert api.decode_soft(dem.fft_mag2.cpu().numpy(), cfg).data.is_cuda
    assert api.soft_symbols(dem.fft_mag2.cpu().numpy(), cfg)[0].is_cuda
    dec, dem = api.loopback(payload, cfg, soft=True)
    assert dec.data.is_cuda and dem.found.is_cuda
    assert api.extract_payloads(dec) == [bytes(payload[0])]
    wide = np.zeros(4 * api.required_samples(cfg), np.complex64)
    assert api.channelized_demodulate(wide, 4, cfg)[0].found.is_cuda
    from lora_tpu_torch.ops import cplx
    assert cplx.as_iq(np.zeros(4)).is_cuda
    assert cplx.from_planar(np.zeros(4), np.zeros(4)).is_cuda
    # tensors stay; a named device moves
    assert not api.encode(torch.as_tensor(payload), cfg).is_cuda
    assert not api.demodulate(iq.cpu(), cfg).found.is_cuda
    assert not api.encode(payload, cfg, device="cpu").is_cuda


# --------------------------------------------------------------------------
# streaming, slab, capture replay: the ring and the staging on the card
# --------------------------------------------------------------------------

def test_device_ring_gather_matches_host_ring_at_a_wrap(dev):
    """The ring on the card (one gather over its mirrored store) cuts the
    windows the same ring on the CPU cuts, including windows that run over
    the end of the store into the mirror, across growth and trims."""
    from lora_tpu_torch.runtime.stream import _Ring

    rng = np.random.default_rng(11)
    B, W = 5, 300
    card, host = _Ring(B, 512, W, dev), _Ring(B, 512, W, "cpu")
    wrapped = 0
    for _ in range(30):
        x = crandn(rng, (B, int(rng.integers(50, 400))), "cpu")
        card.append(x.to(dev))
        host.append(x)
        base = max(card.base, card.end - int(rng.integers(W, 900)))
        card.trim(base)
        host.trim(base)
        if card.end - card.base < W:
            continue
        offs = card.base + rng.integers(0, card.end - card.base - W + 1, B)
        wrapped += int(((offs % card.cap) + W > card.cap).sum())
        got = card.gather(offs, W)
        assert got.is_cuda
        assert torch.equal(got.cpu(), host.gather(offs, W))
        assert torch.equal(card.view(card.base, card.end - card.base).cpu(),
                           host.view(host.base, host.end - host.base))
    assert wrapped > 0 and card.cap == host.cap > 512


def test_staging_buffer_reuse_never_changes_a_copied_block(dev):
    """The pinned-buffer rule: with the copies held behind a busy stream, a
    staging buffer handed out again is written only after its copy has
    read it, so every block lands on the card as it was given."""
    from lora_tpu_torch.runtime.staging import Staging

    staging = Staging(2)
    shape = (4, 1 << 16)
    blocks = [np.full(shape, k + 1j * k, np.complex64) for k in range(6)]
    outs = []
    torch.cuda._sleep(200_000_000)  # the copies queue behind this
    for blk in blocks:
        slot, pinned = staging.take(shape)
        pinned.numpy()[...] = blk
        outs.append(pinned.to(dev, non_blocking=True))
        staging.sent(slot, dev)
    torch.cuda.synchronize()
    for blk, out in zip(blocks, outs):
        assert torch.equal(out.cpu(), torch.as_tensor(blk))


def test_stream_on_card_matches_cpu(dev, launches):
    """StreamDemodulator on the card, fed host blocks (through the pinned
    staging) and through pump: the frames and pointers of the same stream
    on the CPU; kernels A, B, C launched once a step."""
    from lora_tpu_torch.runtime import StreamDemodulator, decode_frames

    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(8) + 2)
    rng = np.random.default_rng(12)
    B = 3
    payload = rng.integers(0, 256, (B, 8)).astype(np.uint8)
    fr = api.modulate(api.encode(payload, cfg, device="cpu"), cfg).numpy()
    x = np.zeros((B, 4 * api.required_samples(cfg)), np.complex64)
    for b in range(B):
        d = 500 + 1700 * b
        x[b, d : d + fr.shape[1]] = fr[b]
    x += 0.05 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    blocks = [x[:, i : i + 3000] for i in range(0, x.shape[1], 3000)]
    key = lambda f: (f.channel, f.t_start, f.data_start, f.payload, f.status)

    def drive(device, pump):
        steps = []
        sd = StreamDemodulator(cfg, B, device=device,
                               observer=lambda *a: steps.append(1))
        if pump:
            frames = list(sd.pump(iter(blocks)))
        else:
            frames = []
            for blk in blocks:
                sd.feed(blk)
                frames.extend(sd.run())
        frames.extend(sd.flush())
        return decode_frames(frames, cfg, device), sd.offsets, len(steps)

    want, offs, _ = drive("cpu", False)
    assert [f.payload for f in want] == [bytes(p) for p in payload]
    for pump in (False, True):
        with launches() as n:
            got, goffs, steps = drive(dev, pump)
        assert [n["detect"], n["track"], n["payload"]] == [steps] * 3
        assert [key(f) for f in got] == [key(f) for f in want]
        np.testing.assert_array_equal(goffs, offs)


def test_resample_stream_bit_equal_on_card(dev, launches):
    """Chunked resample_stream equals the one-shot resample bit for bit on
    the card (the taps summed in one fixed order), at ratios that decimate
    (8/5 among them, the US902-928 cell's) and interpolate, and stays
    within 2e-6 of the CPU's result; each call with outputs is one launch
    of kernel R."""
    from lora_tpu_torch.ops import resample as rs

    rng = np.random.default_rng(13)
    T = 200_003
    x = crandn(rng, (2, T), dev)
    cuts = [0, 7, 1037, 1038, 65536, 65537, 150001, T]
    for ratio in (4.096, 1.7, 1.6, 0.37):
        with launches() as n:
            full = rs.resample(x, ratio)
            assert full.is_cuda
            state, parts = None, []
            for a, b in zip(cuts[:-1], cuts[1:]):
                y, state = rs.resample_stream(x[:, a:b], ratio, state)
                parts.append(y)
        calls = 1 + sum(y.shape[-1] > 0 for y in parts)
        assert n["resample"] == calls
        got = torch.cat(parts, -1)
        n = min(got.shape[-1], full.shape[-1])
        assert n >= full.shape[-1] - 8
        assert torch.equal(got[:, :n], full[:, :n]), ratio
        cpu = rs.resample(x.cpu(), ratio)
        assert (full.cpu() - cpu).abs().max().item() <= 2e-6


def test_dcblock_and_slab_on_card_match_cpu(dev, launches):
    """The DC blocker on the card within 1e-5 of the CPU's (its block matrix
    product in full float32), and demodulate_bank through pinned slabs
    equal to the CPU's, field by field."""
    from lora_tpu_torch.ops import dcblock
    from lora_tpu_torch.runtime import demodulate_bank

    rng = np.random.default_rng(14)
    x = crandn(rng, (3, 300_001), "cpu") + (2.0 - 1.0j)
    y, st = dcblock.dcblock(x.to(dev))
    yc, stc = dcblock.dcblock(x)
    assert (y.cpu() - yc).abs().max().item() <= 1e-5 * 3.0
    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/7", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(5) + 2)
    B, T = 11, api.required_samples(cfg)
    payload = rng.integers(0, 256, (B, 5)).astype(np.uint8)
    fr = api.modulate(api.encode(payload, cfg, device="cpu"), cfg).numpy()
    bank = np.zeros((B, T), np.complex64)
    bank[:, : fr.shape[1]] = fr[:, :T]
    bank += 0.03 * (rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T)))
    with launches() as n:
        got = demodulate_bank(bank.real, bank.imag, cfg, slab=4, device=dev)
    assert n["payload"] == 3
    want = demodulate_bank(bank.real, bank.imag, cfg, slab=4, device="cpu")
    for f in ("found", "symbols", "count", "t_sync", "consumed", "freq_error"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert bool(got.found.all())


@pytest.mark.parametrize("world,backend", [(2, "gloo"), (1, "nccl")])
def test_parallel_ranks_on_card_match_single_process(dev, world, backend):
    """lora_tpu_torch.parallel on ranks that share this card: 2 spawned
    ranks over gloo (NCCL refuses two ranks on one device) and 1 rank over
    NCCL.  The gathered shard_demodulate of an SF7 bank equals demodulate of
    the whole bank in one process (integers and flags equal, dB values and
    fine CFO within 1e-3), with kernels A, B, C launched in the ranks;
    channelize_stream over `world` time shards (kernel D on each, the left
    neighbour's tail as its history, the corner turn) within 1e-4 of one
    channelize of the whole stream."""
    import functools

    import torch_parallel_ranks as ranks
    from lora_tpu_torch.ops import _cuda
    from lora_tpu_torch.parallel.dryrun import launch

    _cuda.library()  # built once, before the ranks load it
    rng = np.random.default_rng(31)
    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(8) + 2)
    B, T = 16, api.required_samples(cfg)
    payload = rng.integers(0, 256, (B, 8)).astype(np.uint8)
    fr = api.modulate(api.encode(payload, cfg, device="cpu"), cfg).numpy()
    x = np.zeros((B, T), np.complex64)
    x[:, : fr.shape[1]] = fr[:, :T]
    x += (0.05 * (rng.standard_normal((B, T))
                  + 1j * rng.standard_normal((B, T)))).astype(np.complex64)
    run = functools.partial(launch, world, backend=backend, device="cuda",
                            timeout=300.0)
    got = run(functools.partial(ranks.bank_demod, x, cfg, 1, device="cuda"))
    want = api.demodulate(torch.as_tensor(x, device=dev), cfg)
    for r in got:
        assert r["local_rows"] == B // world
        for f, a in r["dem"].items():
            b = getattr(want, f).cpu().numpy()
            if f in ("power", "snr", "fine_freq"):
                assert np.abs(a - b).max() <= TOL, f
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)
        assert r["metrics"]["decoded_ok"] == B
        assert r["launches"] == only(detect=1, track=1, payload=1, decode=1)
    wide = crandn(rng, (2, 16 * 1024), "cpu")
    y = run(functools.partial(ranks.channelize, wide.numpy(), 16, world,
                              device="cuda"))
    whole, _ = chz.channelize(wide.to(dev), 16)
    whole = whole.cpu().numpy()
    for r in y:
        assert np.abs(r["y"] - whole).max() <= D_RTOL * np.abs(whole).max()


def test_sensitivity_point_routes_agree_on_card(dev, launches):
    """tools.bench_sensitivity at the committed SF7 CR 4/8 noise 2.0 point
    (128 frames): one bank to fused="auto" (kernels A, B, C; C with mag2)
    and to fused="off"; found, symbols and hard/soft recovered flags equal
    frame by frame."""
    from lora_tpu_torch.tools import bench_sensitivity as bs

    cfg = bs.point_cfg(7, "4/8")
    bank = bs.make_bank(cfg, 2.0, 128, device=dev)
    out = {}
    for fused in ("auto", "off"):
        with launches() as n:
            out[fused] = bs.point(cfg, 2.0, 128, soft=True, fused=fused,
                                  device=dev, bank=bank)
        assert (n["payload"] > 0) == (fused == "auto")
    (row, pf), (orow, opf) = out["auto"], out["off"]
    for k in ("found", "symbols", "hard", "soft"):
        np.testing.assert_array_equal(pf[k], opf[k], err_msg=k)
    assert row["recovered_ours"] == orow["recovered_ours"] > 0


@pytest.mark.parametrize("mode,groups", [("planar", (10,)),
                                         ("host-convert", (10,)),
                                         ("interleaved", (10,)),
                                         ("planar", (10, 8))],
                         ids=["planar", "host-convert", "interleaved",
                              "mixed-sf"])
def test_bench_e2e_two_slabs_on_card(dev, mode, groups):
    """tools.bench_e2e: 2 slabs of 64 channels through pinned staging and
    the depth-1 pipeline in each mode; every frame found and decoded, and
    the measured host-to-device rate positive."""
    from lora_tpu_torch.tools import bench_e2e

    rng = np.random.default_rng(0)
    gs = [bench_e2e.make_group(sf, 64, 32, rng, dev) for sf in groups]
    rec, comp = bench_e2e.run(gs, mode, 128, dev)
    assert rec["frames_found"] == rec["frames_decoded_ok"] == rec["of"] == 128
    assert comp["h2d_GBs_measured"] > 0
    assert comp["link_bytes_per_sample"] == (8 if mode == "host-convert"
                                             else 4)


# --------------------------------------------------------------------------
# captured programs (utils/jit.py): CUDA graphs against the eager route
# --------------------------------------------------------------------------

def _same(a, b):
    """Every field of two results (or two tensors) bit-equal."""
    import dataclasses

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x is None) != (y is None) or (x is not None
                                          and not torch.equal(x, y)):
            return False
    return True


def _program_case(name, sf, dev):
    """(program object, call(x), x resident on the card, launches a call)
    for one entry point at a small SF7/SF8 bank: a captured program, or
    (decode) kernel G's one launch, whose program is None."""
    from lora_tpu_torch.models import softdec as tsoft

    cfg = lora_tpu_torch.LoRaConfig(sf=sf, cr="4/8", ampl=1.0, crc_check=True)
    cfg = cfg.replace(mtu=cfg.num_symbols(6))
    rng = np.random.default_rng(30 + sf)
    bank, _ = _two_frames(cfg, rng, 6, 6)
    bank = torch.as_tensor(bank, device=dev)
    if name == "demodulate":
        return (dm._demod_whole, lambda x: api.demodulate(x, cfg), bank,
                only(detect=1, track=1, payload=1))
    dem = api.demodulate(bank, cfg, spectra=True)
    if name == "decode":
        return (None, lambda x: api.decode(x, cfg), dem.symbols.clone(),
                only(decode=1))
    if name == "soft_symbols":
        return (tsoft._soft_symbols, lambda x: api.soft_symbols(x, cfg),
                dem.fft_mag2.clone(), only())
    K = 16
    wide = crandn(rng, (2, K * api.required_samples(cfg)), dev)
    return (api._channelize_demod_step,
            lambda x: api.channelized_demodulate(x, K, cfg), wide,
            only(detect=1, track=1, payload=1, channelize=1))


@pytest.mark.parametrize("sf", [7, 8])
@pytest.mark.parametrize("name", ["demodulate", "decode", "soft_symbols",
                                  "channelized_demodulate"])
def test_captured_program_replays_as_the_eager_call(dev, launches, name, sf):
    """One capture a key (none for decode, which is kernel G's one launch);
    each call bit-equal to the call under disable_jit(); new data written
    into the input in place gives the new answer; a result already returned
    does not change on the next call; the kernels' launches counted once a
    call, captured or not."""
    from lora_tpu_torch.utils import jit

    prog, call, x, per_call = _program_case(name, sf, dev)
    captures = (lambda: prog.captures) if prog else jit.captures
    jit.clear()
    with jit.disable_jit():
        want = call(x)
    c0 = captures()
    with launches() as n:
        got = [call(x) for _ in range(3)]
    assert captures() == c0 + (1 if prog else 0)
    assert prog is None or prog.replays >= 2
    assert n == {k: 3 * v for k, v in per_call.items()}
    assert all(_same(g, want) for g in got)
    # new data in place: the next call reads it (soft_symbols copies its
    # input into the program's buffer, the banks are read in place, decode
    # reads it where it lies); the results returned before stay as they were
    y = x.flip(0).clone()
    with jit.disable_jit():
        want_y = call(y)
    x.copy_(y)
    again = call(x)
    assert captures() == c0 + (1 if prog else 0)
    assert _same(again, want_y)
    assert all(_same(g, want) for g in got)


def test_captured_demodulate_replays_make_no_host_sync(dev):
    """A replay on a resident bank makes no host sync, for the plain call,
    the spectra and the max_frames = 3 paths and their decoders."""
    from lora_tpu_torch.utils import jit

    cfg = lora_tpu_torch.LoRaConfig(sf=8, cr="4/8", ampl=1.0, crc_check=True)
    cfg = cfg.replace(mtu=cfg.num_symbols(6))
    x, _ = _two_frames(cfg, np.random.default_rng(40), 6, 6)
    x = torch.as_tensor(x, device=dev)
    calls = (lambda: api.demodulate(x, cfg),
             lambda: api.decode_soft(
                 api.demodulate(x, cfg, spectra=True).fft_mag2, cfg),
             lambda: api.decode(api.demodulate(
                 x, cfg, max_frames=3, fused="off").symbols.reshape(
                     -1, cfg.mtu), cfg))
    for c in calls:
        c()
    torch.cuda.synchronize()
    n = jit.captures()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for c in calls:
            c()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert jit.captures() == n


def test_failed_capture_raises_on_card(dev):
    """A program that reads the card back cannot be captured: the call
    raises, and the card goes on working."""
    from lora_tpu_torch.utils import jit

    @jit.program()
    def reads_back(x, device):
        return x * int(x.sum())

    x = torch.ones(4, device=dev)
    with pytest.raises(Exception, match="captur"):
        reads_back(x, dev)
    assert len(reads_back) == 0
    with jit.disable_jit():
        assert reads_back(x, dev).tolist() == [4.0] * 4


def test_demodulate_three_frames_routes_agree_on_card(dev):
    """max_frames=3 on buffers with two frames: fused='auto' (captured and
    under disable_jit) against 'off', every field; the third slot empty."""
    from lora_tpu_torch.utils import jit

    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/8", ampl=1.0, crc_check=True)
    cfg = cfg.replace(mtu=cfg.num_symbols(6))
    x, payload = _two_frames(cfg, np.random.default_rng(41), 6, 6)
    x = torch.as_tensor(x, device=dev)
    auto = [api.demodulate(x, cfg, max_frames=3) for _ in range(2)]
    with jit.disable_jit():
        eager = api.demodulate(x, cfg, max_frames=3)
    off = api.demodulate(x, cfg, max_frames=3, fused="off")
    assert _same(auto[0], eager) and _same(auto[1], eager)
    for f in ("found", "symbols", "count", "t_sync", "consumed", "freq_error",
              "t_candidate", "payload_complete"):
        assert torch.equal(getattr(eager, f), getattr(off, f)), f
    assert bool(eager.found[:, :2].all()) and not bool(eager.found[:, 2].any())
    got = api.extract_payloads(api.decode(eager.symbols[:, :2].reshape(
        12, -1), cfg))
    assert got == [bytes(p) for p in payload.reshape(12, -1)]


def test_slabs_and_stream_steps_replay_one_graph_on_card(dev):
    """demodulate_bank copies each pinned slab into one program's buffer
    (one capture for every slab), and a stream's steps replay one graph
    while its ring keeps its size."""
    from lora_tpu_torch.models.decoder import OK
    from lora_tpu_torch.runtime import StreamDemodulator, decode_frames
    from lora_tpu_torch.runtime import demodulate_bank, stream
    from lora_tpu_torch.utils import jit

    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/8", ampl=1.0, crc_check=True)
    cfg = cfg.replace(mtu=cfg.num_symbols(6))
    rng = np.random.default_rng(42)
    x, payload = _two_frames(cfg, rng, 10, 6)
    jit.clear()
    c0 = dm._demod_whole.captures
    got = demodulate_bank(x.real, x.imag, cfg, slab=4, device=dev)
    assert dm._demod_whole.captures == c0 + 1
    with jit.disable_jit():
        want = demodulate_bank(x.real, x.imag, cfg, slab=4, device=dev)
    assert _same(got, want)
    for kw in ({}, {"soft": True}, {"max_frames": 3}):
        c0 = stream._step.captures
        sd = StreamDemodulator(cfg, 10, device=dev, **kw)
        cap = sd._ring.cap
        blocks = (x[:, i : i + 1500] for i in range(0, x.shape[1], 1500))
        frames = decode_frames(list(sd.pump(blocks)) + sd.flush(), cfg, dev)
        grown = sd._ring.cap != cap
        assert stream._step.captures - c0 == 1 + int(grown)
        ok = sorted((f.channel, f.payload) for f in frames if f.status == OK)
        assert ok == sorted((b, bytes(payload[b, j])) for b in range(10)
                            for j in range(2)), kw


# --------------------------------------------------------------------------
# the transmit half: kernel F, encode and dcblock as captured programs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pre", [8, 12])
@pytest.mark.parametrize("ovs", [1, 2])
@pytest.mark.parametrize("sf", range(7, 13))
def test_modulate_kernel_bit_equal_to_plain(dev, launches, sf, ovs, pre):
    """Kernel F against modulate_plain on the card, two sync words, the
    wrap's edge symbols among random ones: bit-equal (the same float32
    sequence and the same cosf/sinf), one launch a call."""
    rng = np.random.default_rng(200 * sf + 10 * ovs + pre)
    for sync in (0x12, 0x3C):
        cfg = lora_tpu_torch.LoRaConfig(sf=sf, cr="4/8", ovs=ovs, sync=sync,
                                        preamble_symbols=pre, ampl=0.7)
        syms = rng.integers(0, cfg.N, (5, int(rng.integers(9, 40))))
        syms[0, :3] = [0, 1, cfg.N - 1]
        x = torch.as_tensor(syms, device=dev)
        with launches() as n:
            got = tmod.modulate(x, cfg)
        assert n == only(modulate=1)
        want = tmod.modulate_plain(x, cfg)
        assert got.shape == (5, cfg.frame_samples(x.shape[1]))
        assert torch.equal(got, want), (sync, (got - want).abs().max().item())


def test_modulate_kernel_takes_any_integer_layout(dev, launches):
    """int64, a strided view and a 255-byte payload's symbols (a scan over
    more symbols than threads) go through one cast and one launch."""
    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    rng = np.random.default_rng(255)
    pay = rng.integers(0, 256, (4, 255)).astype(np.uint8)
    sym = api.encode(pay, cfg, device=dev)
    assert sym.dtype == torch.int32 and sym.shape[1] > 256
    for x in (sym, sym.long(), sym.t().contiguous().t(), sym[0]):
        with launches() as n:
            got = api.modulate(x, cfg)
        assert n == only(modulate=1)
        assert torch.equal(got, tmod.modulate_plain(x, cfg))
    cpu = api.modulate(sym.cpu(), cfg)
    assert (api.modulate(sym, cfg).cpu() - cpu).abs().max().item() <= 1e-6


def test_modulate_kernel_failure_raises(dev, launches, monkeypatch):
    """A failed build or launch of kernel F raises; modulate never falls back
    to the plain route on the card."""
    from lora_tpu_torch.ops import _cuda, cuda_modulate

    cfg = lora_tpu_torch.LoRaConfig(sf=7)
    x = torch.zeros((2, 10), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="at most"):
        api.modulate(torch.zeros((1, cuda_modulate.MAX_SYMBOLS + 1),
                                 dtype=torch.int32, device=dev), cfg)

    def no_build():
        raise RuntimeError("nvcc failed (1): modulate.cu")

    class Refused:
        @staticmethod
        def lora_modulate(*args):
            return 9  # cudaErrorInvalidConfiguration

    with launches() as n:
        monkeypatch.setattr(_cuda, "library", no_build)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            api.modulate(x, cfg)
        monkeypatch.setattr(_cuda, "library", lambda: Refused)
        with pytest.raises(RuntimeError, match="CUDA error 9"):
            api.modulate(x, cfg)
    assert n == only()


# --------------------------------------------------------------------------
# kernel G: decode in one launch, against its plain version
# --------------------------------------------------------------------------

def _decode_equal(x, cfg, n=None, what=""):
    """api.decode of x on the card (kernel G) against decode_plain of the
    same symbols on the CPU, every field bit-equal.  -> the card's
    result."""
    got = api.decode(x, cfg, n)
    sym = torch.atleast_2d(x.cpu())
    want = tdec.decode_plain(sym, cfg, n or sym.shape[-1])
    if x.dim() == 1:
        want = type(want)(**{f: getattr(want, f)[0] for f in FIELDS})
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape, \
            (what, f)
        assert torch.equal(a.cpu(), b), (what, f)
    return got


@pytest.mark.parametrize("explicit", [True, False])
@pytest.mark.parametrize("sf, cr, ppm", CODES)
def test_decode_kernel_bit_equal_to_plain(dev, launches, sf, cr, ppm,
                                         explicit):
    """Kernel G against decode_plain on every decoder flag of a header
    mode: encoded, damaged and random frames, in int16, int32 and int64
    symbols by turns; every field bit-equal, one launch a call."""
    cfg0, sym = decode_cases(sf, cr, ppm, explicit,
                             1000 * sf + 7 * ppm + int(cr[-1]) + 3 * explicit)
    dtypes = (torch.int16, torch.int32, torch.int64)
    cases = [f for f in FLAGS if f[0] == explicit]
    with launches() as n:
        for i, flags in enumerate(cases):
            cfg = flagged(cfg0, flags)
            x = torch.as_tensor(sym, device=dev).to(dtypes[i % 3])
            _decode_equal(x, cfg, what=f"{cfg} {x.dtype}")
    assert n == only(decode=len(cases))


def test_decode_kernel_reaches_every_status(dev, launches):
    """Over the grid's explicit cases on the card: every status and every
    rate a header can announce (5 to 7 among them); one launch a call."""
    statuses, rates = set(), set()
    with launches() as n:
        for sf, cr, ppm in CODES:
            cfg0, sym = decode_cases(sf, cr, ppm, True, 77 + sf)
            x = torch.as_tensor(sym, device=dev).to(torch.int16)
            for flags in FLAGS[:8]:
                got = _decode_equal(x, flagged(cfg0, flags))
                statuses |= set(got.status.cpu().tolist())
                rates |= set(got.rdd.cpu().tolist())
    assert n == only(decode=len(CODES) * 8)
    assert statuses == set(range(6))
    assert rates == set(range(8))


def test_decode_kernel_takes_any_layout(dev, launches):
    """uint8, int8, a strided view, leading axes [2, 10, S], a single frame
    [S], num_symbols below the width, the Gray passthrough (interleaving
    off, any integer, negative ones too): one launch each, bit-equal."""
    cfg, sym = decode_cases(7, "4/6", 0, True, 41)
    cfg = cfg.replace(crc_check=True)
    x = torch.as_tensor(sym, device=dev)
    S = x.shape[1]
    layouts = (x.to(torch.uint8), x.to(torch.int8), x.t().contiguous().t(),
               x.to(torch.int16)[:, :], torch.cat([x, x]).reshape(2, 20, S),
               x[4])
    with launches() as n:
        for t in layouts:
            _decode_equal(t, cfg, what=f"{t.dtype} {tuple(t.shape)}")
    assert n == only(decode=len(layouts))
    for k in range(S - 8, S):
        try:
            cuda_decode.geometry(cfg, S, k)
        except ValueError:
            continue
        with launches() as n:
            _decode_equal(x, cfg, k, what=f"num_symbols {k}")
        assert n == only(decode=1)
    gray = cfg.replace(interleaving=False)
    rng = np.random.default_rng(42)
    wide = torch.as_tensor(rng.integers(-(1 << 40), 1 << 40, (70, 33)),
                           device=dev)
    for t in (x, x.to(torch.int16), wide):
        with launches() as n:
            got = api.decode(t, gray)
        assert n == only(decode=1)
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), tdec.decode_plain(
            t.cpu(), gray, t.shape[-1]))


@pytest.mark.parametrize("shape, sf, cr, payload", [
    ((4096,), 10, "4/8", 32),     # the SF10 bank cell's decode
    ((256, 64), 7, "4/5", 32),    # the wideband cell's, leading axes kept
    ((96,), 7, "4/8", 255),       # the longest payload
    ((40,), 7, "4/5", None),      # the longest row: fewer frames a block
])
def test_decode_kernel_at_full_width(dev, launches, shape, sf, cr, payload):
    """The cells' shapes, the longest payload and the longest row that
    geometry() accepts (1,465 symbols at SF7 CR 4/5, 2,046 payload
    codewords; its tiles take 32 frames a block, above 48 KB of shared
    memory): encoded frames and random rows, bit-equal to decode_plain."""
    rng = np.random.default_rng(sf + int(cr[-1]))
    cfg = lora_tpu_torch.LoRaConfig(sf=sf, cr=cr, crc_check=True)
    B = int(np.prod(shape))
    if payload is None:
        sym = rng.integers(0, cfg.N, (B, _longest_row(cfg)))
    else:
        pay = rng.integers(0, 256, (B, payload)).astype(np.uint8)
        sym = api.encode(pay, cfg, device="cpu").numpy()
        sym = np.concatenate([sym, rng.integers(0, cfg.N, (B, 4))], 1)
        sym[B // 2 :] = rng.integers(0, cfg.N, sym[B // 2 :].shape)
    x = torch.as_tensor(sym, device=dev).to(torch.int16)
    with launches() as n:
        got = _decode_equal(x.reshape(*shape, -1), cfg, what=str(shape))
    assert n == only(decode=1)
    if payload is not None:
        ok = got.status.reshape(-1)[: B // 2].cpu()
        assert bool((ok == 0).all())


def _longest_row(cfg) -> int:
    """The most symbols a row that geometry() accepts, decoded whole."""
    longest = 0
    for S in range(1, 2 * tables.WHITEN_LEN):
        try:
            cuda_decode.geometry(cfg, S, S)
        except ValueError:
            continue
        longest = S
    return longest


def test_decode_kernel_failure_raises(dev, launches, monkeypatch):
    """What kernel G does not take raises; a failed build or launch raises;
    decode never falls back to the plain route on the card."""
    from lora_tpu_torch.ops import _cuda

    cfg = lora_tpu_torch.LoRaConfig(sf=7)
    x = torch.zeros((2, 20), dtype=torch.int32, device=dev)
    long = torch.zeros((1, _longest_row(cfg) + 8), dtype=torch.int32,
                       device=dev)
    with launches() as n:
        with pytest.raises(ValueError, match="outside"):
            api.decode(long, cfg)
        with pytest.raises(TypeError, match="integer"):
            api.decode(x.float(), cfg)
        with pytest.raises(ValueError, match="codewords"):
            api.decode(x, cfg, 40)
    assert n == only()

    def no_build():
        raise RuntimeError("nvcc failed (1): decode.cu")

    class Refused:
        @staticmethod
        def lora_decode(*args):
            return 9  # cudaErrorInvalidConfiguration

    with launches() as n:
        monkeypatch.setattr(_cuda, "library", no_build)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            api.decode(x, cfg)
        monkeypatch.setattr(_cuda, "library", lambda: Refused)
        with pytest.raises(RuntimeError, match="CUDA error 9"):
            api.decode(x, cfg)
    assert n == only()


def test_encode_and_dcblock_captured_equal_eager(dev):
    """encode and dcblock replay their graphs bit-equal to their calls under
    disable_jit(), the DC blocker's state across a seam, with no host sync
    in a replay."""
    from lora_tpu_torch.models import encoder as tenc
    from lora_tpu_torch.ops import dcblock
    from lora_tpu_torch.utils import jit

    rng = np.random.default_rng(43)
    cfg = lora_tpu_torch.LoRaConfig(sf=8, cr="4/6", ampl=1.0)
    pay = torch.as_tensor(rng.integers(0, 256, (64, 32)).astype(np.uint8),
                          device=dev)
    x = crandn(rng, (4, 50_000), dev) + (1.5 - 0.5j)
    jit.clear()
    with jit.disable_jit():
        sym = api.encode(pay, cfg)
        y0, s0 = dcblock.dcblock(x[:, :20_000])
        y1, s1 = dcblock.dcblock(x[:, 20_000:], state=s0)

    def run():
        a0, t0 = dcblock.dcblock(x[:, :20_000])
        a1, t1 = dcblock.dcblock(x[:, 20_000:], state=t0)
        return api.encode(pay, cfg), a0, t0, a1, t1

    want = (sym, y0, s0, y1, s1)
    for _ in range(3):
        assert _same(run(), want)
    c0 = jit.captures()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert jit.captures() == c0 and _same(got, want)
    assert tenc._encode.replays > 0 and dcblock._dcblock.replays > 0
    cpu = api.encode(pay.cpu(), cfg)
    assert torch.equal(sym.cpu(), cpu)


def test_threads_capture_at_once_in_turns(dev):
    """A thread that captures encode at a new payload length and one that
    captures demodulate at a new bank size and decodes its symbols (kernel
    G, no capture), released together each round (a relay's transmit and
    receive threads): their captures take turns under the capture lock, and
    every result is bit-equal to its disable_jit() call."""
    import threading

    from lora_tpu_torch.utils import jit

    rng = np.random.default_rng(45)
    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/5", ampl=1.0)
    rounds = 4
    pays = [torch.as_tensor(rng.integers(0, 256, (8, 3 + r)).astype(np.uint8),
                            device=dev) for r in range(rounds)]
    banks = [torch.as_tensor(_bank(cfg, rng, 3 + r, 0.05), device=dev)
             for r in range(rounds)]

    def tx(r):
        return api.encode(pays[r], cfg)

    def rx(r):
        dem = api.demodulate(banks[r], cfg)
        return dem, api.decode(dem.symbols, cfg)

    jit.clear()
    with jit.disable_jit():
        want = [[f(r) for r in range(rounds)] for f in (tx, rx)]
    start = threading.Barrier(2)
    got, errors = [[], []], []

    def work(i, f):
        try:
            for r in range(rounds):
                start.wait(timeout=60)
                got[i].append(f(r))
            torch.cuda.current_stream().synchronize()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            start.abort()

    c0 = jit.captures()
    threads = [threading.Thread(target=work, args=(i, f))
               for i, f in enumerate((tx, rx))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert jit.captures() - c0 == 2 * rounds
    for i in range(2):
        for a, b in zip(got[i], want[i]):
            assert _same(a, b)
    jit.clear()


# -- kernel R, the fractional resampler ---------------------------------------

def _resample_input(rng, layout, T, dev):
    """complex64 input of T samples a row in a layout kernel R must read
    where it lies: rows [R, T], a column stride of 2, leading axes, and
    leading axes whose strides do not merge (a transposed bank)."""
    if layout == "rows":
        return crandn(rng, (13, T), dev)
    if layout == "col_stride":
        return crandn(rng, (5, 2 * T), dev)[:, ::2]
    if layout == "leading":
        return crandn(rng, (3, 5, T), dev)
    return crandn(rng, (5, 3, T), dev).transpose(0, 1)


@pytest.mark.parametrize("ratio", [1.6, 0.625, 0.37, 1.7, 4.096])
@pytest.mark.parametrize("layout", ["rows", "col_stride", "leading",
                                    "unmerged"])
@pytest.mark.parametrize("start", ["head", "mid-period"])
def test_resample_kernel_matches_plain(dev, launches, ratio, layout, start):
    """Kernel R bit-equal to the plain route on the card and on the CPU, at
    ratios under and over 1, row counts and output lengths that are no
    multiple of a block's rows or tile, any strides, edge-clamped taps at
    both ends (out_len past the input's end), at a stream's head and in a
    block that starts mid-period (`block_plan` after a first block of 1,003
    samples); the register-blocked route runs at 8/5 and 5/8, the general
    route at the others (the profiler's "blocked" launches)."""
    from fractions import Fraction

    from lora_tpu_torch.ops import resample as rs

    rng = np.random.default_rng(int(ratio * 1000))
    T = 10_007
    x = _resample_input(rng, layout, T, dev)
    if start == "head":
        M = int(T / ratio) + 3
        plan = rs.plan_on(0, M, ratio, 0, dev)
    else:
        exact = Fraction(ratio).limit_denominator(10**6)
        _, m_next, origin = rs.block_plan(None, 1003, exact, dev)
        Lt = rs.history(1003, ratio)
        state = rs.ResampleState(m_next, origin, x[..., :Lt])
        plan, _, _ = rs.block_plan(state, T - Lt, exact, dev)
        M = plan.table.shape[1]
    blocked = ratio in (1.6, 0.625)
    if start != "head" and blocked:
        assert m_next % exact.denominator  # the block starts mid-period
    assert (plan.runs is not None) == blocked
    with launches() as n:
        got = rs.weigh(x, plan, ratio)
    assert n == only(resample=1, blocked=int(blocked))
    assert got.shape == x.shape[:-1] + (M,) and got.is_contiguous()
    assert torch.equal(got, rs.weigh(x, plan, ratio, plain=True))
    cpu = rs.weigh(x.cpu(), plan._replace(table=plan.table.cpu()), ratio)
    assert torch.equal(got.cpu(), cpu)
    if blocked:  # the general route gives the same
        assert torch.equal(got, rs.weigh(x, plan._replace(runs=None), ratio))


def test_resample_kernel_at_the_cells_shape(dev, launches):
    """8,192 rows of 65,536 samples -> 40,960 at 8/5 (the US902-928 cell's
    channels) on the register-blocked route, bit-equal to the plain route;
    one launch a call."""
    from lora_tpu_torch.ops import resample as rs

    g = torch.Generator(device=dev).manual_seed(41)
    x = torch.randn((8192, 65536), dtype=torch.complex64, device=dev,
                    generator=g)
    plan = rs.plan_on(0, 40960, 1.6, 0, dev)
    assert plan.runs is not None  # the register-blocked route
    with launches() as n:
        got = rs.weigh(x, plan, 1.6)
    assert n == only(resample=1, blocked=1)
    for lo in range(0, 8192, 2048):  # the plain route's temporaries, in parts
        assert torch.equal(got[lo : lo + 2048],
                           rs.weigh(x[lo : lo + 2048], plan, 1.6,
                                    plain=True)), lo


def _spaced_case(dev, seed=43):
    """A small US902-928-style wideband block on the card: K = 16 slots of
    SF7 at 8/5 of its rate, a frame on every slot."""
    from fractions import Fraction

    from lora_tpu_torch.ops import resample as rs

    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/5", ampl=1.0,
                                    preamble_symbols=8, sync=0x34)
    cfg = cfg.replace(mtu=cfg.num_symbols(8) + 2)
    K, S, Mp = 16, 2, 7680
    Mw = Mp * 8 // 5
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (S * K, 8)).astype(np.uint8)
    fr = api.modulate(api.encode(payload, cfg, device="cpu"), cfg).numpy()
    u = np.zeros((S * K, Mp), np.complex64)
    for c in range(S * K):
        d = int(rng.integers(0, cfg.N))
        u[c, d : d + fr.shape[1]] = fr[c]
    up = rs.resample(torch.as_tensor(u), 0.625, out_len=Mw, device="cpu")
    wide, _ = chz.synthesize(up.reshape(S, K, Mw))
    wide = wide + 0.01 * torch.complex(torch.randn(wide.shape),
                                       torch.randn(wide.shape))
    return cfg, K, Fraction(8, 5), wide.to(dev), payload


def test_spaced_slots_on_card_match_the_plain_route(dev, launches):
    """channelized_demodulate(slot_ratio=8/5) on the card: one captured
    program running kernels D, R (its register-blocked route), A, B, C once
    each a call, equal to the eager call bit for bit and to the plain route
    in its decisions, every frame byte-exact; a replay makes no host sync;
    the state's halves give the whole's resampled grid."""
    from lora_tpu_torch.utils import jit

    cfg, K, r, wide, payload = _spaced_case(dev)
    call = lambda: api.channelized_demodulate(wide, K, cfg, slot_ratio=r)
    jit.clear()
    with jit.disable_jit():
        want, wstate = call()
    c0 = api._channelize_demod_step.captures
    with launches() as n:
        got = [call() for _ in range(3)]
    assert api._channelize_demod_step.captures == c0 + 1
    # kernel R on its register-blocked route
    assert n == only(channelize=3, resample=3, blocked=3, detect=3, track=3,
                     payload=3)
    for g, st in got:
        assert _same(g, want) and torch.equal(st[0], wstate[0])
        assert torch.equal(st[1].tail, wstate[1].tail)
        assert st[1][:2] == wstate[1][:2]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    off, _ = api.channelized_demodulate(wide, K, cfg, fused="off",
                                        slot_ratio=r)
    for f in ("found", "t_sync", "count", "freq_error", "symbols"):
        assert torch.equal(getattr(want, f), getattr(off, f)), f
    dec = api.decode(want.symbols.reshape(-1, cfg.mtu), cfg)
    assert api.extract_payloads(dec) == [bytes(p) for p in payload.tolist()]
    jit.clear()
