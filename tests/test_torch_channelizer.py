"""The port's wideband front end (lora_tpu_torch/ops/channelizer.py,
ops/cuda_channelize.py, api.channelized_demodulate) against lora_tpu on the
same numpy inputs, state included.

Channel outputs within 1e-5 (float32 sums of another order), new_state
exactly equal; demod frame fields equal per channel, dB values and fine
CFO within 1e-3, payloads byte-exact.  The JAX package runs on the CPU:
its XLA pipeline, and its Pallas filterbanks in interpret mode.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lora_tpu
from lora_tpu import api as japi
from lora_tpu.ops import channelizer as jchz
from lora_tpu.ops import pallas_channelize as jpc
from lora_tpu.ops.cplx import IQ

from lora_tpu_torch import api as tapi
from lora_tpu_torch.ops import channelizer as chz
from lora_tpu_torch.ops import cuda_channelize as cc
from lora_tpu_torch.ops import _cuda, cplx, tables

torch.set_num_threads(1)

EXACT = ("found", "symbols", "t_sync", "consumed", "count", "freq_error",
         "found_pre", "t_candidate", "payload_complete")
CLOSE = ("power", "snr", "fine_freq")


def crandn(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def jiq(a):
    return IQ(jnp.asarray(a.real), jnp.asarray(a.imag))


def jnp_c(v):
    return np.asarray(v.re) + 1j * np.asarray(v.im)


@pytest.mark.parametrize("K", [16, 32, 64, 192])
def test_channelize_matches_jax(K):
    rng = np.random.default_rng(K)
    S, M = 2, 48
    x = crandn(rng, (S, K * M))
    st = crandn(rng, (S, 8 * K - 1))
    jy, js = jchz.channelize(jiq(x), K, state=jiq(st), impl="xla")
    y, s = chz.channelize(torch.as_tensor(x), K, state=torch.as_tensor(st))
    assert y.shape == (S, K, M) and y.is_contiguous()
    np.testing.assert_allclose(y.numpy(), jnp_c(jy), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(s.numpy(), jnp_c(js))


def _xp(rng, S, K, M):
    return crandn(rng, (S, (M + 7) * K))


def test_filterbank_plain_matches_filterbank_fir():
    """JAX's factorized kernel (_filterbank_fir) at the config-3 geometry."""
    rng = np.random.default_rng(1)
    K, M = 64, 48
    xp = _xp(rng, 2, K, M)
    want = jnp_c(jpc.filterbank_fir(jiq(xp), K, 8, M, interpret=True))
    got = cc.filterbank_plain(torch.as_tensor(xp), K, 8, M)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_filterbank_plain_matches_dense_filterbank():
    """JAX's dense block-Toeplitz kernel (_filterbank), channel-minor."""
    rng = np.random.default_rng(2)
    K, M = 16, 48
    xp = _xp(rng, 2, K, M)
    want = jnp_c(jpc.filterbank(jiq(xp), K, 8, M, interpret=True))
    got = cc.filterbank_plain(torch.as_tensor(xp), K, 8, M)
    np.testing.assert_allclose(got.numpy(), want.swapaxes(-1, -2), rtol=0,
                               atol=1e-5)


def test_fir_kernel_at_k192_matches_xla():
    """pallas_channelize.fir_geometry admits K = 192, a width no JAX test
    ran: its interpret-mode kernel agrees with the XLA pipeline there, and
    so does the port."""
    rng = np.random.default_rng(3)
    K, M = 192, 48
    assert jpc.fir_geometry(K, 8)
    x = crandn(rng, (1, K * M))
    st = crandn(rng, (1, 8 * K - 1))
    want, _ = jchz.channelize(jiq(x), K, state=jiq(st), impl="xla")
    fir, _ = jchz.channelize(jiq(x), K, state=jiq(st), impl="fir-interpret")
    np.testing.assert_allclose(jnp_c(fir), jnp_c(want), rtol=0, atol=1e-5)
    y, _ = chz.channelize(torch.as_tensor(x), K, state=torch.as_tensor(st),
                          impl="fir")
    np.testing.assert_allclose(y.numpy(), jnp_c(want), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# a CPU model of kernel D (lora_tpu_torch/csrc/channelize.cu)
# --------------------------------------------------------------------------

CHANNELIZE_CU = (_cuda.CSRC / "channelize.cu").read_text()
MAX_SMEM = int(re.search(r"kMaxSmem = (\d+);", CHANNELIZE_CU).group(1))
W32 = np.exp(-2j * np.pi * np.arange(16) / 32)


KRUN = int(re.search(r"constexpr int kRun = (\d+);", CHANNELIZE_CU).group(1))


@dataclasses.dataclass(frozen=True)
class Plan:
    """Route 1's geometry of one width K (channelize.cu BankPlan and
    BankGeo): radices R0, R1, tile TM; threads, FIR items a thread, the FIR
    output's row stride KP, the exchange buffer, and shared memory at filter
    length L."""
    K: int
    R0: int
    R1: int
    TM: int

    @property
    def threads(self):
        return self.TM * self.R1

    @property
    def items(self):
        return self.R0 // KRUN

    @property
    def KP(self):
        return self.K + (1 if self.TM >= 16 else 2)

    @property
    def n_ex(self):
        if self.R1 == 1:
            return 0
        return (self.K + (self.K // self.R1 if self.TM < 16 else 0)) * self.TM

    @property
    def n_ub(self):
        return max(self.TM * self.KP, self.n_ex)

    @property
    def n_tw(self):
        return self.K if self.R1 > 1 else 0

    def smem(self, L):
        """The twiddles, then the staged rows [TM + L - 1][K], over which
        u' and the exchange buffer lie."""
        return 8 * (self.n_tw + max((self.TM + L - 1) * self.K, self.n_ub))


def bank_plan(K):
    """Route 1's Plan of width K from channelize.cu's BankPlan table, or
    None where K takes the direct-sum route."""
    lk = K.bit_length() - 1
    m = re.search(r"struct BankPlan<%d>\s*\{ enum \{ R0 = (\d+),\s*R1 = (\d+)"
                  r",\s*TM = (\d+) \}" % lk, CHANNELIZE_CU)
    if K != 1 << lk or m is None:
        return None
    return Plan(K, *(int(g) for g in m.groups()))


def brev(p, bits):
    return int(format(p, f"0{bits}b")[::-1], 2) if bits else 0


def fft_reg(v):
    """fft.cuh's fft_reg<R> on the last axis, in place: radix-2 decimation
    in frequency, natural order in, bit-reversed out."""
    R = v.shape[-1]
    h = R // 2
    while h >= 1:
        for b in range(0, R, 2 * h):
            for i in range(h):
                a, c = v[..., b + i].copy(), v[..., b + i + h].copy()
                v[..., b + i] = a + c
                v[..., b + i + h] = (a - c) * W32[i * (16 // h)]
        h //= 2


def stream_at(x, state, hist, i):
    """Sample i of state ++ x through the kernel's two pointers: the history
    below `hist` (zeros without a state), the block after."""
    i = np.asarray(i)
    out = np.zeros(i.shape, np.complex128)
    blk = i >= hist
    out[blk] = x[i[blk] - hist]
    if state is not None:
        out[~blk] = state[i[~blk]]
    return out


def lanes_conflict_free(addr):
    """Shared-memory addresses (8-byte words) by thread: every 16
    consecutive threads read or write 16 different banks (threads on one
    word share it)."""
    addr = np.asarray(addr).reshape(-1)
    return all(len({int(a) % 16 for a in set(addr[lo : lo + 16].tolist())})
               == len(set(addr[lo : lo + 16].tolist()))
               for lo in range(0, addr.size, 16))


def conflict_free(addr, TM, R1):
    """Shared-memory addresses (8-byte words) by (m, c): every 16 consecutive
    threads (tid = c * TM + m) hit 16 different banks."""
    flat = np.broadcast_to(addr, (TM, R1)).T.reshape(-1)
    return all(len(set(int(a) % 16 for a in flat[lo : lo + 16])) == 16
               for lo in range(0, flat.size, 16))


def fft_route_model(x, state, K, L, M, hp, wk):
    """channelize_fft_kernel<log2 K> on one stream, tile by tile: the
    tile's TM + L - 1 rows staged as [row][K] (zero past M + L - 1); the
    FIR by runs of KRUN samples of one position p, lanes along p, at the
    rotated phase q = (p - 1) mod K; u'[m][p] over the staged rows once all
    are read; the first pass, the pass twiddles, the exchange buffer over
    u', the second pass and the channel each register holds."""
    P = bank_plan(K)
    R0, R1, TM, KP, NT = P.R0, P.R1, P.TM, P.KP, P.threads
    lk = K.bit_length() - 1
    hist = L * K - 1
    assert R0 * R1 == K and (R1 == 1 or R0 % R1 == 0)
    assert TM % KRUN == 0 and R0 % KRUN == 0 and NT <= 1024
    assert P.smem(L) <= MAX_SMEM
    # tw[m' * R1 + c] = conj(wk[(c m') mod K])
    i = np.arange(K)
    tw = np.conj(wk[((i // R1) * (i % R1)) & (K - 1)])
    ps = R1.bit_length() - 1
    pad = (lambda p: p + (p >> ps)) if TM < 16 else (lambda p: p)
    m = np.arange(TM)[:, None]
    c = np.arange(R1)[None, :]
    y = np.full((K, M), np.nan, np.complex128)
    stored = np.zeros((K, M), int)
    rows = TM + L - 1
    for m0 in range(0, M, TM):
        valid = min(rows, M + L - 1 - m0)
        xs = np.full(P.smem(L) // 8 - P.n_tw, np.nan, np.complex128)
        i = np.arange(rows * K)
        xs[i] = np.where(i >> lk < valid, stream_at(
            x, state, hist, np.minimum(m0 * K + i, hist + x.size - 1)), 0)
        v = np.zeros((P.items, NT, KRUN), np.complex128)
        for it in range(P.items):
            j = np.arange(NT) + it * NT
            q = ((j & (K - 1)) - 1) & (K - 1)
            k0 = (j >> lk) * KRUN
            for r in range(KRUN + L - 1):
                addr = (k0 + r) * K + q  # phase q of row m0 + k0 + r
                assert K < 16 or lanes_conflict_free(addr)
                for i in range(KRUN):
                    if 0 <= r - i < L:
                        v[it, :, i] += hp[L - 1 - (r - i)][q] * xs[addr]
        ub = xs  # u' lies over the staged rows
        ub[:] = np.nan
        for it in range(P.items):
            j = np.arange(NT) + it * NT
            for i in range(KRUN):
                addr = ((j >> lk) * KRUN + i) * KP + (j & (K - 1))
                assert lanes_conflict_free(addr)
                ub[addr] = v[it, :, i]
        w = np.zeros((TM, R1, R0), np.complex128)
        for j in range(R0):
            addr = m * KP + c + R1 * j
            assert conflict_free(addr, TM, R1)
            w[:, :, j] = ub[addr]
        assert not np.isnan(w).any()  # every u' read was written
        fft_reg(w)
        live = m0 + m[:, 0] < M
        mm = m0 + m[live, 0]
        if R1 == 1:
            for k in range(R0):
                y[k, mm] = w[live, 0, brev(k, lk)]
                stored[k, mm] += 1
            continue
        ex = ub  # the exchange buffer lies over u'
        ex[:] = np.nan
        for mp in range(R0):
            a = w[:, :, brev(mp, R0.bit_length() - 1)]
            if mp:
                a = a * tw[mp * R1 + c]
            addr = pad(c + R1 * mp) * TM + m
            assert conflict_free(addr, TM, R1)
            ex[addr] = a
        for b in range(R0 // R1):
            f = c + R1 * b
            z = np.zeros((TM, R1, R1), np.complex128)
            for j in range(R1):
                addr = pad(f * R1 + j) * TM + m
                assert conflict_free(addr, TM, R1)
                z[:, :, j] = ex[addr]
            assert not np.isnan(z).any()  # every position read was written
            fft_reg(z)
            for mq in range(R1):
                k = (f + R0 * mq)[0]
                y[k[:, None], mm[None, :]] = z[live, :, brev(mq, ps)].T
                stored[k[:, None], mm[None, :]] += 1
    assert (stored == 1).all()  # every channel of every sample stored once
    return y


def direct_route_model(x, state, K, L, M, hp, wk, TM=32):
    """channelize_kernel (any K) on one stream, in tiles of TM output
    samples: staged rows (zero past M + L - 1), flip-folded FIR, and the
    IDFT over the K-entry twiddle table with the kernel's index
    recurrence."""
    hist = L * K - 1
    k = np.arange(K)
    y = np.zeros((K, M), np.complex128)
    for m0 in range(0, M, TM):
        valid = min(TM + L - 1, M + L - 1 - m0)
        xs = np.zeros((TM + L - 1, K), np.complex128)
        xs[:valid] = stream_at(
            x, state, hist, m0 * K + np.arange(valid * K)).reshape(valid, K)
        u = sum(hp[L - 1 - d] * xs[d : d + TM] for d in range(L))
        j = np.where(k == 0, 0, K - k)  # ((K-1)*k) mod K
        acc = np.zeros((K, TM), np.complex128)
        for q in range(K):
            acc += wk[j][:, None] * u[None, :, q]
            j = np.where(j - k < 0, j - k + K, j - k)
        n = min(TM, M - m0)
        y[:, m0 : m0 + n] = acc[:, :n]
    return y


def kernel_d_model(x, state, K, L, M):
    """csrc/channelize.cu's arithmetic in numpy (complex128) on streams
    x [S, M*K] after histories state [S, L*K - 1] (None: zeros), on the route
    lora_channelize_route picks by K."""
    hp, wk = (t.numpy() for t in cc.consts(K, L, torch.device("cpu")))
    hp = hp.astype(np.float64)
    wk = wk.astype(np.complex128)
    model = fft_route_model if bank_plan(K) else direct_route_model
    return np.stack([
        model(x[s].astype(np.complex128),
              None if state is None else state[s].astype(np.complex128),
              K, L, M, hp, wk) for s in range(x.shape[0])])


def test_bank_plan_covers_the_powers_of_two():
    """One pass for K = 8, 16, 32, two for 64 to 1024, radices the register
    FFT has, whole warps along m where shared memory allows, tiles of whole
    FIR runs and whole items a thread; route 1 takes any filter up to L = 399
    at K <= 64, and up to 195 at K = 128, 81 at 256, 40 at 512, 20 at 1024
    (a tile of 32 samples at K = 256 leaves L = 82 to 97 to the direct sum);
    every other K takes the direct sum."""
    for K in (8, 16, 32, 64, 128, 256, 512, 1024):
        P = bank_plan(K)
        R0, R1, TM = P.R0, P.R1, P.TM
        assert R0 * R1 == K and R0 in (8, 16, 32) and R1 in (1, 8, 16, 32)
        assert (R1 == 1) == (K <= 32)
        assert TM & (TM - 1) == 0 and 128 <= TM * R1 <= 512
        assert TM % KRUN == 0 and K * TM // KRUN == P.items * P.threads
    longest = {K: max(L for L in range(1, 400)
                      if bank_plan(K).smem(L) <= MAX_SMEM)
               for K in (8, 16, 32, 64, 128, 256, 512, 1024)}
    assert longest == {8: 399, 16: 399, 32: 399, 64: 399, 128: 195, 256: 81,
                       512: 40, 1024: 20}
    assert [bank_plan(K) for K in (4, 24, 192, 2048)] == [None] * 4


# M odd at the wide banks keeps the plain product's matrix small (G = 1)
@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("K,L,M", [(8, 12, 600), (16, 8, 300), (24, 4, 50),
                                   (32, 4, 333), (64, 8, 130), (128, 8, 70),
                                   (192, 8, 70), (256, 12, 40), (512, 8, 37),
                                   (1024, 4, 19)])
def test_kernel_d_arithmetic_matches_plain(K, L, M, with_state):
    """The kernel's two-pointer stream (the seam at L*K - 1, with a history
    and with none), its radix plan per K, pass twiddles, bit-reversed
    registers, rotated phases in place of a per-channel twist, exchange
    positions and ragged last tile, and the direct sum where K is no power
    of two, give what the plain block-Toeplitz product gives."""
    rng = np.random.default_rng(K + L)
    x = crandn(rng, (2, M * K))
    state = crandn(rng, (2, L * K - 1)) if with_state else None
    xp = chz.prepended(torch.as_tensor(x),
                       None if state is None else torch.as_tensor(state),
                       L * K - 1)
    want = cc.filterbank_plain(xp, K, L, M).numpy()
    got = kernel_d_model(x, state, K, L, M)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("K,L,M", [(64, 8, 1), (64, 8, 31), (64, 8, 33),
                                   (8, 8, 255), (8, 8, 257), (1024, 16, 9),
                                   (512, 32, 17)])
def test_kernel_d_staged_seams_match_plain(K, L, M, with_state):
    """Route 1's staged rows and FIR runs at the seams of a tile: a stream
    shorter than a tile, one sample short of and past a tile edge, the
    stream's end (zero rows after it), history and block within one tile
    and one run; and long filters at the widest banks (K = 1024, L = 16 and
    K = 512, L = 32), whose staged rows fill most of shared memory."""
    rng = np.random.default_rng(K * 7 + M)
    x = crandn(rng, (1, M * K))
    state = crandn(rng, (1, L * K - 1)) if with_state else None
    xp = chz.prepended(torch.as_tensor(x),
                       None if state is None else torch.as_tensor(state),
                       L * K - 1)
    want = cc.filterbank_plain(xp, K, L, M).numpy()
    got = kernel_d_model(x, state, K, L, M)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_next_state_is_the_tail_of_the_stream():
    """new_state comes from the tails alone and equals the last L*K - 1
    samples of state ++ x, for blocks longer and shorter than the history,
    with a state and with none."""
    rng = np.random.default_rng(11)
    K, L = 16, 4
    hist = L * K - 1
    for T in (K, 3 * K, hist + 1, 6 * K):
        for st in (torch.as_tensor(crandn(rng, (2, hist))), None):
            x = torch.as_tensor(crandn(rng, (2, T)))
            want = chz.prepended(x, st, hist)[..., T:]
            assert torch.equal(chz.next_state(x, st, hist), want)
            assert torch.equal(chz.channelize(x, K, L, state=st)[1], want)


def test_streaming_continuity():
    """Two chunks with carried state equal one shot."""
    rng = np.random.default_rng(4)
    K, M = 64, 64
    x = torch.as_tensor(crandn(rng, (K * M,)))
    y_full, s_full = chz.channelize(x, K)
    y1, st = chz.channelize(x[: K * M // 2], K)
    y2, s2 = chz.channelize(x[K * M // 2 :], K, state=st)
    torch.testing.assert_close(torch.cat([y1, y2], -1), y_full, rtol=0,
                               atol=1e-6)
    assert torch.equal(s2, s_full)


def no_kernel():
    raise AssertionError("the CPU route loaded the kernels' library")


def test_routes_on_the_cpu(monkeypatch):
    """On a CPU tensor every kernel route takes the plain version (the
    kernels' library never loads), and the product runs in full float32
    whatever the caller set."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(crandn(rng, (2, 16 * 48)))
    want, _ = chz.channelize(x, 16, impl="xla")
    monkeypatch.setattr(_cuda, "library", no_kernel)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        for impl in ("auto", "fir", "pallas"):
            y, _ = chz.channelize(x, 16, impl=impl)
            torch.testing.assert_close(y, want, rtol=0, atol=2e-6)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    with pytest.raises(ValueError, match="impl"):
        chz.channelize(x, 16, impl="dense")
    with pytest.raises(ValueError, match="divisible"):
        chz.channelize(x[:, :100], 16)


def test_synthesize_and_helpers_match_jax():
    rng = np.random.default_rng(6)
    K, M = 16, 64
    u = crandn(rng, (2, K, M))
    st = crandn(rng, (2, K, 7))
    jx, js = jchz.synthesize(jiq(u), state=jiq(st))
    x, s = chz.synthesize(torch.as_tensor(u), state=torch.as_tensor(st))
    np.testing.assert_allclose(x.numpy(), jnp_c(jx), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(s.numpy(), jnp_c(js))
    # chunked synthesis with carried state equals one shot
    x1, s1 = chz.synthesize(torch.as_tensor(u[..., : M // 2]))
    x2, _ = chz.synthesize(torch.as_tensor(u[..., M // 2 :]), state=s1)
    x0, _ = chz.synthesize(torch.as_tensor(u))
    torch.testing.assert_close(torch.cat([x1, x2], -1), x0, rtol=0, atol=1e-5)

    nb = crandn(rng, (2, 40))
    for chan, T_out in ((3, None), (13, 700)):
        want = jnp_c(jchz.upconvert(jiq(nb), K, chan, T_out))
        got = chz.upconvert(torch.as_tensor(nb), K, chan, T_out).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want = jnp_c(jchz.synthesize_tone(1000, 0.21 / K, ampl=0.7))
    np.testing.assert_allclose(chz.synthesize_tone(1000, 0.21 / K, 0.7).numpy(),
                               want, rtol=0, atol=1e-5)


def assert_demod_equal(tdem, jdem, what=""):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(tdem, f).numpy(),
                                      np.asarray(getattr(jdem, f)),
                                      err_msg=f"{what}{f}")
    for f in CLOSE:
        np.testing.assert_allclose(getattr(tdem, f).numpy(),
                                   np.asarray(getattr(jdem, f)), atol=1e-3,
                                   err_msg=f"{what}{f}")


def payloads_of(dem, cfg, port):
    """Payload bytes (None where dropped) of every channel, flattened."""
    if port:
        return tapi.extract_payloads(
            tapi.decode(dem.symbols.reshape(-1, cfg.mtu), cfg))
    return japi.extract_payloads(
        japi.decode(dem.symbols.astype(jnp.int32).reshape(-1, cfg.mtu), cfg))


def three_channel_capture(cfg, K, rng):
    """Frames on channels 2, 7 and 13 of a K-channel grid, upconverted and
    summed, plus noise far below the signal (test_channelizer.py's
    test_channelized_demodulate_api)."""
    chans = [2, 7, 13]
    payloads = {c: rng.integers(0, 256, 6).astype(np.uint8) for c in chans}
    need = tapi.required_samples(cfg) + 64
    wide = 0
    for c, p in payloads.items():
        nb = tapi.modulate(tapi.encode(p[None], cfg, device="cpu"), cfg)[0]
        nb = torch.nn.functional.pad(nb, (40 * c, need - nb.shape[-1] - 40 * c))
        wide = wide + chz.upconvert(nb, K, c)
    T = (wide.shape[-1] // (2 * K)) * (2 * K)
    wide = wide[:T].numpy() + 1e-2 * crandn(rng, (T,)).real
    return wide.astype(np.complex64), payloads


def test_channelized_demodulate_matches_jax():
    """One shot and in two chunks with carried state: every field equal per
    channel, payloads byte-exact, on both of the port's routes."""
    K = 16
    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/6", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(6) + 2)
    wide, payloads = three_channel_capture(cfg, K, np.random.default_rng(7))
    jdem, _ = japi.channelized_demodulate(jiq(wide), K, cfg, fused="off")
    assert np.asarray(jdem.found)[list(payloads)].all()
    for fused in ("auto", "off"):
        tdem, tst = tapi.channelized_demodulate(torch.as_tensor(wide), K, cfg,
                                                fused=fused)
        assert tdem.found.shape == (K,) and tst.shape == (1, 8 * K - 1)
        assert_demod_equal(tdem, jdem, f"{fused}:")
    got = payloads_of(tdem, cfg, True)
    assert got == payloads_of(jdem, cfg, False)
    for c, p in payloads.items():
        assert got[c] == bytes(p), c

    half = wide.shape[-1] // 2
    jstate = tstate = None
    for lo in (0, half):
        chunk = wide[None, lo : lo + half]
        jd, jstate = japi.channelized_demodulate(jiq(chunk), K, cfg,
                                                 state=jstate, fused="off")
        td, tstate = tapi.channelized_demodulate(torch.as_tensor(chunk), K,
                                                 cfg, state=tstate)
        assert td.found.shape == (1, K)
        assert_demod_equal(td, jd, f"chunk {lo}:")
        np.testing.assert_array_equal(tstate.numpy(), jnp_c(jstate))
        assert payloads_of(td, cfg, True) == payloads_of(jd, cfg, False)


def every_even_channel(rng, K, cfg):
    """The chip run's traffic in miniature: SF7 frames with 16-byte
    payloads on every even channel of a K-channel grid (random delay in
    [0, N), CFO k + u bins with |u| < 0.4, random phase), merged by the
    synthesis bank, AWGN 0.01 at the wideband rate.  -> (wide complex64
    numpy [K * M], occupied channels, payloads)."""
    N, M = cfg.N, tapi.required_samples(cfg)
    chans = np.arange(0, K, 2)
    payload = rng.integers(0, 256, (len(chans), 16)).astype(np.uint8)
    frames = tapi.modulate(tapi.encode(payload, cfg, device="cpu"), cfg).numpy()
    u = np.zeros((K, M), np.complex64)
    n = np.arange(M)
    for i, c in enumerate(chans):
        d = int(rng.integers(0, N))
        u[c, d : d + frames.shape[1]] = frames[i, : M - d]
        cfo = rng.integers(-2, 3) + rng.uniform(-0.4, 0.4)
        u[c] *= np.exp(2j * np.pi * cfo * n / N + 1j * rng.uniform(0, 2 * np.pi))
    wide, _ = chz.synthesize(torch.as_tensor(u))
    wide = (wide.numpy() + 0.01 * crandn(rng, (K * M,))).astype(np.complex64)
    return wide, chans, payload


def test_every_even_channel_round_trip():
    """Both packages find every frame of every_even_channel's traffic,
    decode it byte-exact and agree on every channel."""
    rng = np.random.default_rng(8)
    K = 16
    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 2)
    wide, chans, payload = every_even_channel(rng, K, cfg)
    jdem, _ = japi.channelized_demodulate(jiq(wide), K, cfg, fused="off")
    tdem, _ = tapi.channelized_demodulate(torch.as_tensor(wide), K, cfg)
    assert_demod_equal(tdem, jdem)
    got = payloads_of(tdem, cfg, True)
    assert got == payloads_of(jdem, cfg, False)
    assert tdem.found[chans].all()
    assert [got[c] for c in chans] == [bytes(p) for p in payload.tolist()]


def test_out_of_slice_options_raise():
    """The interpret routes have no CUDA counterpart; the channelizer's
    bfloat16 contraction (which lora_tpu runs on every backend, also under
    channelized_demodulate(fused="bf16")) is ported and runs."""
    cfg = lora_tpu.LoRaConfig(sf=7, mtu=8)
    wide = torch.zeros(16 * tapi.required_samples(cfg), dtype=torch.complex64)
    for fused in ("interpret", "interpret-bf16"):
        with pytest.raises(NotImplementedError, match="no CUDA counterpart"):
            tapi.channelized_demodulate(wide, 16, cfg, fused=fused)
    for impl in ("fir-interpret", "pallas-interpret"):
        with pytest.raises(NotImplementedError, match="no CUDA counterpart"):
            chz.channelize(wide, 16, impl=impl)
        with pytest.raises(NotImplementedError, match="no CUDA counterpart"):
            chz.channelize(wide, 16, impl=impl, bf16=True)
    y, _ = chz.channelize(wide, 16, bf16=True)
    assert y.shape == (16, wide.shape[-1] // 16) and not bool(y.any())
    x, _ = chz.synthesize(torch.zeros((16, 8), dtype=torch.complex64),
                          bf16=True)
    assert x.shape == (128,) and not bool(x.any())
    dem, _ = tapi.channelized_demodulate(wide, 16, cfg, fused="bf16")
    assert dem.found.shape == (16,) and not bool(dem.found.any())
    # the receive options are in the port: every K channel of an empty
    # wideband block reports no frame, with the spectra and candidate axes
    dem, _ = tapi.channelized_demodulate(wide, 16, cfg, spectra=True,
                                         max_frames=2)
    assert dem.found.shape == (16, 2) and not bool(dem.found.any())
    assert dem.fft_mag2.shape == (16, 2, cfg.mtu, cfg.N)
    assert "channelized_demodulate" in tapi.__all__
    # the demod result keeps the JAX package's field names
    names = {f.name for f in dataclasses.fields(tapi.DemodResult)}
    assert set(EXACT + CLOSE) <= names


# --------------------------------------------------------------------------
# the bfloat16 contraction (channelize/synthesize bf16=True)
# --------------------------------------------------------------------------

# The plain bf16 product against lora_tpu's XLA bf16 product: both round the
# same operands to bfloat16 and sum their exact float32 products, in another
# order: 1e-5 of the output's peak.
BF16_SUM_RTOL = 1e-5
# filterbank_fir_plain against lora_tpu's factorized kernel with
# bf16=True (and kernel D's bf16 route against the plain version): the FIR
# output u may differ by a float32 step (a fused multiply-add or not), and
# then its two bfloat16 roundings by one bfloat16 step (2^-8 of |u|): on at
# least 99% of the samples within 1e-5 of the peak, everywhere within 1e-2.
BF16_FIR_RTOL = 1e-5
BF16_FIR_SHARE = 0.99
BF16_FIR_MAX_RTOL = 1e-2
# lora_tpu's own bar for its bf16 kernels on unit-variance noise
# (tests/test_pallas_channelize.py:62-65), absolute
BF16_KERNEL_ATOL = 3e-2


def bf16_fir_close(got, want):
    """The two bars of BF16_FIR_*; -> (share within 1e-5, max rel)."""
    peak = np.abs(want).max()
    d = np.abs(got - want) / peak
    share = float((d <= BF16_FIR_RTOL).mean())
    assert share >= BF16_FIR_SHARE, share
    assert d.max() <= BF16_FIR_MAX_RTOL, d.max()
    return share, float(d.max())


@pytest.mark.parametrize("K", [16, 64])
def test_channelize_bf16_product_matches_jax(K, monkeypatch):
    """channelize(bf16=True) under "xla", and every impl on a CPU tensor
    (no kernel: lora_tpu off a TPU runs its XLA product), against
    lora_tpu's channelize(bf16=True, impl="xla"); new_state exact."""
    rng = np.random.default_rng(20 + K)
    S, M = 2, 48
    x = crandn(rng, (S, K * M))
    st = crandn(rng, (S, 8 * K - 1))
    jy, js = jchz.channelize(jiq(x), K, state=jiq(st), impl="xla", bf16=True)
    want = jnp_c(jy)
    monkeypatch.setattr(_cuda, "library", no_kernel)
    for impl in ("xla", "auto", "fir", "pallas"):
        y, s = chz.channelize(torch.as_tensor(x), K, state=torch.as_tensor(st),
                              bf16=True, impl=impl)
        np.testing.assert_allclose(y.numpy(), want, rtol=0,
                                   atol=BF16_SUM_RTOL * np.abs(want).max())
        np.testing.assert_array_equal(s.numpy(), jnp_c(js))
    # bf16 moves the channels by about 1e-3 of their peak, not more
    f32, _ = chz.channelize(torch.as_tensor(x), K, state=torch.as_tensor(st))
    rel = (f32 - y).abs().max().item() / f32.abs().max().item()
    assert 1e-5 < rel < 1e-2, rel


def test_synthesize_bf16_matches_jax():
    rng = np.random.default_rng(21)
    K, M = 16, 64
    u = crandn(rng, (2, K, M))
    st = crandn(rng, (2, K, 7))
    jx, js = jchz.synthesize(jiq(u), state=jiq(st), bf16=True)
    x, s = chz.synthesize(torch.as_tensor(u), state=torch.as_tensor(st),
                          bf16=True)
    want = jnp_c(jx)
    np.testing.assert_allclose(x.numpy(), want, rtol=0,
                               atol=BF16_SUM_RTOL * np.abs(want).max())
    np.testing.assert_array_equal(s.numpy(), jnp_c(js))


@pytest.mark.parametrize("with_state", [True, False])
def test_filterbank_fir_plain_bf16_matches_fir_interpret(with_state):
    """Kernel D's bf16 plain version against lora_tpu's factorized kernel
    (_filterbank_fir, bf16=True: FIR output and IDFT matrix in bfloat16,
    float32 accumulation) in interpret mode, at K = 64, L = 8, M = 48, S = 2;
    the channelizer's new_state bit-equal."""
    rng = np.random.default_rng(22)
    K, L, M, S = 64, 8, 48, 2
    x = crandn(rng, (S, K * M))
    st = crandn(rng, (S, L * K - 1)) if with_state else None
    jy, js = jchz.channelize(jiq(x), K, state=None if st is None else jiq(st),
                             impl="fir-interpret", bf16=True)
    tst = None if st is None else torch.as_tensor(st)
    xp = chz.prepended(torch.as_tensor(x), tst, L * K - 1)
    got = cc.filterbank_fir_plain(xp, K, L, M)
    assert got.shape == (S, K, M) and got.is_contiguous()
    bf16_fir_close(got.numpy(), jnp_c(jy))
    _, s = chz.channelize(torch.as_tensor(x), K, L, state=tst, bf16=True)
    np.testing.assert_array_equal(s.numpy(), jnp_c(js))
    # the wrapper on a CPU tensor gives lora_tpu's bf16 product off a TPU,
    # as channelize does, not this function
    jx, _ = jchz.channelize(jiq(x), K, state=None if st is None else jiq(st),
                            impl="xla", bf16=True)
    want = jnp_c(jx)
    y = cc.filterbank(torch.as_tensor(x), K, L, tst, bf16=True)
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=BF16_SUM_RTOL * np.abs(want).max())


def test_filterbank_fir_plain_bf16_within_dense_kernel_bar():
    """lora_tpu's dense kernel (_filterbank) rounds its input and its
    block-Toeplitz matrix to bfloat16 instead: the two agree within its own
    bf16 bar, 3e-2, at K = 16."""
    rng = np.random.default_rng(23)
    K, L, M = 16, 8, 48
    xp = _xp(rng, 1, K, M)
    want = jnp_c(jpc.filterbank(jiq(xp), K, L, M, interpret=True, bf16=True))
    got = cc.filterbank_fir_plain(torch.as_tensor(xp), K, L, M)
    err = np.abs(got.numpy() - want.swapaxes(-1, -2)).max()
    assert err < BF16_KERNEL_ATOL, err


@pytest.mark.parametrize("K", [16, 64, 128, 192])
def test_bf16_idft_matrix_matches_jax(K):
    """The plain version's rounded IDFT matrix is lora_tpu's
    _fir_idft_consts matrix after astype(bfloat16), bit for bit; so is the
    matrix kernel D's bf16 route multiplies (idft_packed), entry by entry
    of W_big = [[Wt_re, -Wt_im], [Wt_im, Wt_re]]."""
    _, wb = jpc._fir_idft_consts(K, 8)
    w16 = np.asarray(jnp.asarray(wb).astype(jnp.bfloat16).astype(jnp.float32))
    w = cc.idft_flipped(K, torch.device("cpu"))
    # W_big = [[Wt_re, -Wt_im], [Wt_im, Wt_re]] with Wt[k, q] = w[q, k]
    np.testing.assert_array_equal(w16[:K, :K], w.real.numpy().T)
    np.testing.assert_array_equal(w16[K:, :K], w.imag.numpy().T)
    np.testing.assert_array_equal(w16[:K, K:], -w.imag.numpy().T)
    packed = cc.idft_packed(K, torch.device("cpu")).float().numpy()
    lane = np.arange(32)
    n = cc.mma_width(K) // 8
    t, ks = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    for half in (0, 1):
        q = 8 * ks[..., None] + lane % 4 + 4 * half
        k = 8 * t[..., None] + lane // 4
        for j, (r, c) in enumerate(((k, q), (k, K + q), (K + k, q),
                                    (K + k, K + q))):
            np.testing.assert_array_equal(packed[..., 4 * half + j],
                                          w16[r, c])


def bf16_np(a):
    """Complex numpy with re and im rounded to bfloat16 (nearest even)."""
    return cplx.round_bf16(torch.from_numpy(
        np.ascontiguousarray(a, np.complex64))).numpy()


# route 3 (channelize_mma_kernel): its constants, read from the source
MMA_THREADS = int(re.search(r"kMmaThreads = (\d+);", CHANNELIZE_CU).group(1))
FIR_RUN = int(re.search(r"kFirRun = (\d+);", CHANNELIZE_CU).group(1))
UB_PAD = int(re.search(r"kUbPad = (\d+);", CHANNELIZE_CU).group(1))


def mma_tile(K):
    """channelize.cu mma_tile: output samples a block of route 3 owns."""
    KW = cc.mma_width(K)
    smem = lambda TM: 4 * TM * (KW + UB_PAD)
    TM = 256 if KW <= 32 else 128 if KW <= 64 else 64
    while TM > 32 and smem(TM) > MAX_SMEM // 2:
        TM //= 2
    while TM > 8 and smem(TM) > MAX_SMEM:
        TM //= 2
    return TM if smem(TM) <= MAX_SMEM else 0


def a_tiles(wb):
    """The A fragments of idft_packed as [tile, k-step, 16, 16] float64, by
    mma.m16n8k16's layout: register pair j of lane 4g + i holds rows g +
    8 ((j // 2) % 2), columns 2i + j % 2 + 8 (j // 4)."""
    n = wb.shape[0]
    a = np.full((n, n, 16, 16), np.nan)
    lane = np.arange(32)
    g, i = lane // 4, lane % 4
    for j in range(8):
        row = g + 8 * ((j // 2) % 2)
        col = 2 * i + j % 2 + 8 * (j // 4)
        a[:, :, row, col] = wb[:, :, :, j]
    assert not np.isnan(a).any()  # every element of every tile held once
    return a


def mma_route_model(x, state, K, L, M, hp, wb):
    """channelize_mma_kernel<NG, LT> on one stream, in float32 as the kernel
    computes: tiles of TM output samples (a ragged last one), the stream
    read across the history seam, the FIR items of FIR_RUN samples in its
    tap order (fmaf as one float32 rounding of a float64 sum), u rounded to
    bfloat16 into ub [TM][KW + UB_PAD] (zero phases past K), B fragments by
    ldmatrix's addresses, A from the packed matrix, float32 sums in blocks
    of the MMA depth (16), and the accumulators' stores."""
    hist = L * K - 1
    KW = cc.mma_width(K)
    SW = KW + UB_PAD
    TM = mma_tile(K)
    NG = 4 if TM >= 32 else TM // 8
    KS, pairs, groups = KW // 8, KW // 16, TM // (8 * NG)
    assert TM % (8 * NG) == 0 and 4 * TM * SW <= MAX_SMEM
    A = a_tiles(wb)
    h = hp.astype(np.float32)
    fma = lambda a, b, c: (a.astype(np.float64) * b + c).astype(np.float32)
    lane = np.arange(32)
    g, i = lane // 4, lane % 4
    y = np.full((K, M), np.nan, np.complex128)
    for m0 in range(0, M, TM):
        avail = M + L - 1 - m0
        rows = np.arange(TM + L - 1)
        idx = (m0 + rows)[:, None] * K + np.arange(K)
        xs = np.where(rows[:, None] < avail, stream_at(
            x, state, hist, np.minimum(idx, hist + x.size - 1)),
            0).astype(np.complex64)
        ub = np.full((TM, SW), np.nan, np.complex64)
        for r0 in range(0, TM, FIR_RUN):
            run = xs[r0 : r0 + FIR_RUN + L - 1]  # the rows an item loads
            ur = h[L - 1] * run[:FIR_RUN].real
            ui = h[L - 1] * run[:FIR_RUN].imag
            for d in range(1, L):
                ur = fma(h[L - 1 - d], run[d : d + FIR_RUN].real, ur)
                ui = fma(h[L - 1 - d], run[d : d + FIR_RUN].imag, ui)
            ub[r0 : r0 + FIR_RUN, :K] = bf16_np(ur + 1j * ui)
            ub[r0 : r0 + FIR_RUN, K:KW] = 0
        flat = ub.reshape(-1)
        acc = np.zeros((2 * KW, TM), np.float32)
        for item in range(pairs * groups):  # every warp item once
            p, n0 = item // groups, (item % groups) * 8 * NG
            for nt in range(NG):
                for ks in range(KS):
                    # ldmatrix.x2: lanes 0-15 give the rows of matrices 0, 1
                    addr = ((n0 + nt * 8 + (lane[:16] & 7)) * SW + ks * 8
                            + ((lane[:16] >> 3) & 1) * 4)
                    for mat in (addr[:8], addr[8:]):
                        assert len(set((mat % 32) // 4)) == 8  # no conflict
                    words = np.stack([flat[addr[:8][g] + i],
                                      flat[addr[8:][g] + i]])  # [b01|b23, l]
                    B = np.zeros((16, 8))
                    for half in (0, 1):
                        B[8 * half + 2 * i, g] = words[half].real
                        B[8 * half + 2 * i + 1, g] = words[half].imag
                    assert not np.isnan(B).any()
                    cols = slice(n0 + nt * 8, n0 + nt * 8 + 8)
                    for t in (2 * p, 2 * p + 1):
                        r = slice(16 * t, 16 * t + 16)
                        acc[r, cols] = (acc[r, cols].astype(np.float64)
                                        + A[t, ks] @ B).astype(np.float32)
        # the stores: tile t, lane 4g + i: channel 8t + g, samples 2i, 2i + 1
        for t in range(KW // 8):
            k = 8 * t + g
            for n in range(0, TM, 8):
                c = acc[16 * t : 16 * t + 16, n : n + 8]
                for dm, (re, im) in enumerate(((c[g, 2 * i], c[g + 8, 2 * i]),
                                               (c[g, 2 * i + 1],
                                                c[g + 8, 2 * i + 1]))):
                    m = m0 + n + 2 * i + dm
                    keep = (k < K) & (m < M)
                    assert np.isnan(y[k[keep], m[keep]]).all()
                    y[k[keep], m[keep]] = re[keep] + 1j * im[keep]
    assert not np.isnan(y).any()  # every channel of every sample once
    return y


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("K,L,M", [(16, 8, 300), (24, 8, 133), (64, 8, 130),
                                   (192, 8, 70), (1024, 4, 19)])
def test_kernel_d_bf16_route_matches_plain(K, L, M, with_state):
    """Kernel D's bf16 route (route 3: the FIR in float32, the IDFT on the
    tensor cores) replayed in numpy in the kernel's own terms gives
    filterbank_fir_plain within the bars of BF16_FIR_*, and lora_tpu's
    factorized kernel with bf16=True (interpret mode) where it takes K."""
    rng = np.random.default_rng(K + 7 * L)
    x = crandn(rng, (2, M * K))
    state = crandn(rng, (2, L * K - 1)) if with_state else None
    xp = chz.prepended(torch.as_tensor(x),
                       None if state is None else torch.as_tensor(state),
                       L * K - 1)
    want = cc.filterbank_fir_plain(xp, K, L, M).numpy()
    hp, _ = cc.consts(K, L, torch.device("cpu"))
    wb = cc.idft_packed(K, torch.device("cpu")).float().numpy()
    got = np.stack([mma_route_model(
        x[s], None if state is None else state[s], K, L, M, hp.numpy(), wb)
        for s in range(2)])
    bf16_fir_close(got, want)
    if jpc.fir_geometry(K, L):
        jy, _ = jchz.channelize(jiq(x), K, L,
                                state=None if state is None else jiq(state),
                                impl="fir-interpret", bf16=True)
        bf16_fir_close(got, jnp_c(jy))


@pytest.mark.parametrize("K", [8, 12, 64, 192, 1024])
def test_packed_idft_matrix_reads_back(K):
    """idft_packed read back as complex, by the fragment layout it states,
    is idft_flipped(K) bit for bit, with zeros past K; each lane's
    (Wr, -Wi, Wi, Wr) pairs agree."""
    KW = cc.mma_width(K)
    n = KW // 8
    wb = cc.idft_packed(K, torch.device("cpu")).float().numpy()
    assert wb.shape == (n, n, 32, 8) and KW % 16 == 0 and KW - K < 16
    lane = np.arange(32)
    g, i = lane // 4, lane % 4
    t, ks = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    w = np.full((KW, KW), np.nan, np.complex128)
    for half in (0, 1):
        re, mre, im, re2 = (wb[..., 4 * half + j] for j in range(4))
        np.testing.assert_array_equal(mre, -im)
        np.testing.assert_array_equal(re2, re)
        q = 8 * ks[..., None] + i + 4 * half
        k = 8 * t[..., None] + g
        assert np.isnan(w[q, k]).all()
        w[q, k] = re + 1j * im
    np.testing.assert_array_equal(
        w[:K, :K], cc.idft_flipped(K, torch.device("cpu")).numpy())
    assert not w[K:].any() and not w[:, K:].any()


def test_channelized_demodulate_bf16_matches_jax():
    """channelized_demodulate(fused="bf16") against lora_tpu's on the
    every-even-channel traffic at SF7, K = 16: on the occupied channels
    every integer field equal and every payload byte-exact, dB values and
    fine CFO within 1e-3."""
    rng = np.random.default_rng(24)
    K = 16
    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 2)
    wide, chans, payload = every_even_channel(rng, K, cfg)
    jdem, _ = japi.channelized_demodulate(jiq(wide), K, cfg, fused="bf16")
    tdem, _ = tapi.channelized_demodulate(torch.as_tensor(wide), K, cfg,
                                          fused="bf16")
    for f in EXACT:
        np.testing.assert_array_equal(getattr(tdem, f).numpy()[chans],
                                      np.asarray(getattr(jdem, f))[chans],
                                      err_msg=f)
    for f in CLOSE:
        np.testing.assert_allclose(getattr(tdem, f).numpy()[chans],
                                   np.asarray(getattr(jdem, f))[chans],
                                   atol=1e-3, err_msg=f)
    got = payloads_of(tdem, cfg, True)
    jgot = payloads_of(jdem, cfg, False)
    want = [bytes(p) for p in payload.tolist()]
    assert [got[c] for c in chans] == [jgot[c] for c in chans] == want
