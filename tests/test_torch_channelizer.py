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
from lora_tpu_torch.ops import _cuda, tables

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


def bank_plan(K):
    """(R0, R1, TM) of width K from channelize.cu's BankPlan table, or None
    where K takes the direct-sum route."""
    lk = K.bit_length() - 1
    m = re.search(r"struct BankPlan<%d>\s*\{ enum \{ R0 = (\d+),\s*R1 = (\d+)"
                  r",\s*TM = (\d+) \}" % lk, CHANNELIZE_CU)
    if K != 1 << lk or m is None:
        return None
    return tuple(int(g) for g in m.groups())


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


def conflict_free(addr, TM, R1):
    """Shared-memory addresses (8-byte words) by (m, c): every 16 consecutive
    threads (tid = c * TM + m) hit 16 different banks."""
    flat = np.broadcast_to(addr, (TM, R1)).T.reshape(-1)
    return all(len(set(int(a) % 16 for a in flat[lo : lo + 16])) == 16
               for lo in range(0, flat.size, 16))


def fft_route_model(x, state, K, L, M, hp, wk):
    """channelize_fft_kernel<log2 K> on one stream: tiles of TM output
    samples, the staged rows (stride KP, zero past M + L - 1), the FIR into
    registers at the rotated phases, the first pass, the pass twiddles, the
    exchange buffer over the staged rows, the second pass and the channel
    each register holds."""
    R0, R1, TM = bank_plan(K)
    lk = K.bit_length() - 1
    hist = L * K - 1
    assert R0 * R1 == K and (R1 == 1 or R0 % R1 == 0)
    KP = K + (1 if TM >= 16 else 2)
    ps = R1.bit_length() - 1
    pad = (lambda p: p + (p >> ps)) if TM < 16 else (lambda p: p)
    n_ex = (K + (K // R1 if TM < 16 else 0)) * TM if R1 > 1 else 0
    rows = TM + L - 1
    smem = 8 * ((K if R1 > 1 else 0) + max(rows * KP, n_ex))
    assert smem <= MAX_SMEM and TM * R1 <= 1024
    # tw[m' * R1 + c] = conj(wk[(c m') mod K])
    i = np.arange(K)
    tw = np.conj(wk[((i // R1) * (i % R1)) & (K - 1)])
    m = np.arange(TM)[:, None]
    c = np.arange(R1)[None, :]
    y = np.full((K, M), np.nan, np.complex128)
    for m0 in range(0, M, TM):
        valid = min(rows, M + L - 1 - m0)
        xs = np.full(max(rows * KP, n_ex), np.nan, np.complex128)
        i = np.arange(rows * K)
        r, q = i >> lk, i & (K - 1)
        xs[r * KP + q] = np.where(r < valid, stream_at(
            x, state, hist, np.minimum(m0 * K + i, hist + x.size - 1)), 0)
        q0 = (c - 1) & (K - 1)
        v = np.zeros((TM, R1, R0), np.complex128)
        for d in range(L):
            for j in range(R0):
                q = q0 if j == 0 else c - 1 + R1 * j
                assert conflict_free((m + d) * KP + q, TM, R1)
                v[:, :, j] += hp[L - 1 - d][q] * xs[(m + d) * KP + q]
        assert not np.isnan(v).any()
        fft_reg(v)
        live = m0 + m[:, 0] < M
        mm = m0 + m[live, 0]
        if R1 == 1:
            for k in range(R0):
                y[k, mm] = v[live, 0, brev(k, lk)]
            continue
        ex = xs  # the exchange buffer lies over the staged rows
        ex[:] = np.nan
        for mp in range(R0):
            a = v[:, :, brev(mp, R0.bit_length() - 1)]
            if mp:
                a = a * tw[mp * R1 + c]
            addr = pad(c + R1 * mp) * TM + m
            assert conflict_free(addr, TM, R1)
            ex[addr] = a
        for b in range(R0 // R1):
            f = c + R1 * b
            w = np.zeros((TM, R1, R1), np.complex128)
            for j in range(R1):
                addr = pad(f * R1 + j) * TM + m
                assert conflict_free(addr, TM, R1)
                w[:, :, j] = ex[addr]
            assert not np.isnan(w).any()  # every position read was written
            fft_reg(w)
            for mq in range(R1):
                k = (f + R0 * mq)[0]
                y[k[:, None], mm[None, :]] = w[live, :, brev(mq, ps)].T
    assert not np.isnan(y).any()  # every channel of every sample stored once
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
    FFT has, whole warps along m where shared memory allows; every other K
    takes the direct sum."""
    for K in (8, 16, 32, 64, 128, 256, 512, 1024):
        R0, R1, TM = bank_plan(K)
        assert R0 * R1 == K and R0 in (8, 16, 32) and R1 in (1, 8, 16, 32)
        assert (R1 == 1) == (K <= 32)
        assert TM & (TM - 1) == 0 and 128 <= TM * R1 <= 512
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


def test_routes_on_the_cpu():
    """On a CPU tensor every kernel route takes the plain version (no
    launch), and the product runs in full float32 whatever the caller
    set."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(crandn(rng, (2, 16 * 48)))
    want, _ = chz.channelize(x, 16, impl="xla")
    before = cc.filterbank.launches
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        for impl in ("auto", "fir", "pallas"):
            y, _ = chz.channelize(x, 16, impl=impl)
            torch.testing.assert_close(y, want, rtol=0, atol=2e-6)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert cc.filterbank.launches == before
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


def test_every_even_channel_round_trip():
    """The chip run's traffic in miniature: SF7 frames with 16-byte
    payloads on every even channel of a 16-channel grid (random delay in
    [0, N), CFO k + u bins with |u| < 0.4, random phase), merged by the
    synthesis bank, AWGN 0.01 at the wideband rate.  Both packages find
    every frame, decode it byte-exact and agree on every channel."""
    rng = np.random.default_rng(8)
    K = 16
    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 2)
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
    jdem, _ = japi.channelized_demodulate(jiq(wide), K, cfg, fused="off")
    tdem, _ = tapi.channelized_demodulate(torch.as_tensor(wide), K, cfg)
    assert_demod_equal(tdem, jdem)
    got = payloads_of(tdem, cfg, True)
    assert got == payloads_of(jdem, cfg, False)
    assert tdem.found[chans].all()
    assert [got[c] for c in chans] == [bytes(p) for p in payload.tolist()]


def test_out_of_slice_options_raise():
    """The channelizer's bfloat16 contraction (which lora_tpu runs on every
    backend, also under channelized_demodulate(fused="bf16")) is not
    ported yet (ROADMAP.md item 5); the interpret routes have no CUDA
    counterpart."""
    cfg = lora_tpu.LoRaConfig(sf=7, mtu=8)
    wide = torch.zeros(16 * tapi.required_samples(cfg), dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 5"):
        tapi.channelized_demodulate(wide, 16, cfg, fused="bf16")
    for fused in ("interpret", "interpret-bf16"):
        with pytest.raises(NotImplementedError, match="no CUDA counterpart"):
            tapi.channelized_demodulate(wide, 16, cfg, fused=fused)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 5"):
        chz.channelize(wide, 16, bf16=True)
    for impl in ("fir-interpret", "pallas-interpret"):
        with pytest.raises(NotImplementedError, match="no CUDA counterpart"):
            chz.channelize(wide, 16, impl=impl)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 5"):
        chz.synthesize(torch.zeros((16, 8), dtype=torch.complex64), bf16=True)
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
