"""Slots spaced wider than the LoRa bandwidth: the port's wideband front end
with slot_ratio (api.channelized_demodulate: the filterbank, then every
channel resampled to the LoRa rate, then the demodulator), on the CPU at a
small size (K = 8, 2 streams, SF7, 200-kHz slots carrying 125-kHz LoRa,
seeded payloads).

Its plain route (fused="off") against lora_tpu's channelize, resample and
demodulate/decode composed on the same numpy input, and against the
benchmark's plain reference (phybench/reference) composed the same way:
every integer field equal, dB values and fine CFO within 1e-3, payloads
byte-exact.  A block fed in two halves with the returned state gives the
decisions of the whole, and slot_ratio = 1 is the route without a
resampler.
"""

import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lora_tpu
from lora_tpu import api as japi
from lora_tpu.ops import channelizer as jchz
from lora_tpu.ops import cplx as jcplx
from lora_tpu.ops import resample as jrs
from lora_tpu.ops.cplx import IQ

from lora_tpu_torch import api as tapi
from lora_tpu_torch.ops import channelizer as chz
from lora_tpu_torch.ops import resample as trs

torch.set_num_threads(1)

K, S = 8, 2
RATIO = Fraction(8, 5)  # 200-kHz slots, 125-kHz LoRa
EXACT = ("found", "symbols", "t_sync", "consumed", "count", "freq_error",
         "found_pre", "t_candidate", "payload_complete")
CLOSE = ("power", "snr", "fine_freq")


def radio(**kw):
    """SF7 with the US902-928 uplinks' framing (CR 4/5, preamble 8, sync
    0x34) and 8-byte payloads, for both packages."""
    fields = dict(sf=7, cr="4/5", ampl=1.0, preamble_symbols=8, sync=0x34,
                  **kw)
    cfg = lora_tpu.LoRaConfig(**fields)
    return cfg.replace(mtu=cfg.num_symbols(8) + 2)


# LoRa-rate samples of a block: at least required_samples (7168 at SF7
# with 8-byte payloads), a multiple of N and of 5
HALF = 7680


def spaced_block(rng, cfg, frames_at, Mp):
    """Wideband [S, K * Mw] with a frame on each channel at the LoRa-rate
    sample frames_at[c] + a delay under one symbol (CFO k + u, |k| <= 2,
    |u| < 0.4, a phase), interpolated to the slot rate by 5/8 (Mw = Mp *
    8/5), merged by the synthesis bank, AWGN 0.01.  -> (wide complex64
    numpy, payloads [S*K, 8])."""
    N = cfg.N
    Mw = int(Mp * RATIO)
    payload = rng.integers(0, 256, (S * K, 8)).astype(np.uint8)
    fr = tapi.modulate(tapi.encode(payload, cfg, device="cpu"), cfg).numpy()
    u = np.zeros((S * K, Mp), np.complex64)
    n = np.arange(Mp)
    for c in range(S * K):
        d = int(frames_at[c % K]) + int(rng.integers(0, N))
        take = min(fr.shape[1], Mp - d)
        u[c, d : d + take] = fr[c, :take]
        cfo = rng.integers(-2, 3) + rng.uniform(-0.4, 0.4)
        u[c] *= np.exp(2j * np.pi * cfo * n / N + 1j * rng.uniform(0, 6.3))
    up = trs.resample(torch.as_tensor(u), 1 / RATIO, out_len=Mw,
                      device="cpu")
    wide, _ = chz.synthesize(up.reshape(S, K, Mw))
    noise = rng.standard_normal((2, S, K * Mw)).astype(np.float32)
    wide = wide.numpy() + 0.01 * (noise[0] + 1j * noise[1])
    return wide.astype(np.complex64), payload


def lora_tpu_composed(wide, cfg, Mp):
    """lora_tpu's channelize, resample, demodulate and decode."""
    jy, _ = jchz.channelize(IQ(jnp.asarray(wide.real),
                               jnp.asarray(wide.imag)), K, impl="xla")
    jr = jrs.resample(jy, float(RATIO), out_len=Mp)
    y = jcplx.to_complex(jr).reshape(S * K, Mp)
    dem = japi.demodulate(jnp.asarray(y), cfg)
    dec = japi.decode(dem.symbols.astype(jnp.int32), cfg)
    out = {f: np.asarray(getattr(dem, f)) for f in EXACT + CLOSE}
    out["payloads"] = japi.extract_payloads(dec)
    return out


def reference_composed(wide, cfg, Mp):
    """phybench/reference's channelize, resample, demodulate and decode."""
    from phybench.reference import channelizer as rch
    from phybench.reference import lora as rlora
    from phybench.reference import resample as rres
    from phybench.reference import rx

    rcfg = rlora.Radio(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(rlora.Radio)})
    y = rch.channelize(torch.as_tensor(wide), K, 8)
    y = rres.resample(y.reshape(S * K, -1), float(RATIO), out_len=Mp)
    dem = rx.demodulate(y, rcfg)
    dec = rx.decode(dem["symbols"], rcfg)
    out = {f: dem[f].numpy() for f in EXACT + CLOSE if f in dem}
    ok = dec["status"] == 0
    out["payloads"] = [
        bytes(dec["data"][i, o : o + n].tolist()) if ok[i] else None
        for i, (o, n) in enumerate(zip(dec["offset"].tolist(),
                                       dec["length"].tolist()))]
    return out


def flat(dem):
    return {f: getattr(dem, f).reshape(S * K, *getattr(dem, f).shape[2:])
            .numpy() for f in EXACT + CLOSE}


@pytest.mark.parametrize("against", ["lora_tpu", "reference"])
def test_spaced_slots_match(against):
    """Every slot's frame found and byte-exact; every field of the port's
    plain route equal to the composition's."""
    cfg = radio()
    rng = np.random.default_rng(19)
    Mp = HALF
    wide, payload = spaced_block(rng, cfg, np.zeros(K, int), Mp)
    dem, state = tapi.channelized_demodulate(
        torch.as_tensor(wide), K, cfg, fused="off", slot_ratio=RATIO)
    assert dem.found.shape == (S, K) and bool(dem.found.all())
    assert state[0].shape == (S, 8 * K - 1)
    assert state[1].m_next == Mp and state[1].tail.shape[:2] == (S, K)
    got = tapi.extract_payloads(tapi.decode(dem.symbols.reshape(S * K, -1),
                                            cfg))
    assert got == [bytes(p) for p in payload.tolist()]
    want = (lora_tpu_composed if against == "lora_tpu"
            else reference_composed)(wide, cfg, Mp)
    mine = flat(dem)
    for f in EXACT:
        if f in want:
            np.testing.assert_array_equal(mine[f], want[f], err_msg=f)
    for f in CLOSE:
        np.testing.assert_allclose(mine[f], want[f], rtol=0, atol=1e-3,
                                   err_msg=f)
    assert got == want["payloads"]


def test_spaced_block_in_two_halves_gives_the_decisions_of_the_whole():
    """Frames on the even channels in a block's first half and on the odd
    ones in its second: fed in two halves with the returned state, each
    frame's decisions are the whole block's (t_sync counted from the half),
    the resampler's output grid and history carried across the seam."""
    cfg = radio()
    N = cfg.N
    half = HALF
    assert half >= tapi.required_samples(cfg) and half % (5 * N) == 0
    rng = np.random.default_rng(23)
    at = np.where(np.arange(K) % 2, half, 0)
    wide, payload = spaced_block(rng, cfg, at, 2 * half)
    x = torch.as_tensor(wide)
    whole, _ = tapi.channelized_demodulate(x, K, cfg, slot_ratio=RATIO)
    cut = x.shape[-1] // 2
    first, st = tapi.channelized_demodulate(x[:, :cut], K, cfg,
                                            slot_ratio=RATIO)
    assert st[1].m_next == half
    second, st = tapi.channelized_demodulate(x[:, cut:], K, cfg, state=st,
                                             slot_ratio=RATIO)
    assert st[1].m_next == 2 * half
    assert bool(whole.found.all())
    for part, chans, shift in ((first, slice(0, K, 2), 0),
                               (second, slice(1, K, 2), half)):
        for f in EXACT:
            a = getattr(part, f)[:, chans]
            b = getattr(whole, f)[:, chans]
            if f in ("t_sync", "consumed", "t_candidate"):
                b = b - shift
            assert torch.equal(a, b), f
        for f in CLOSE:
            torch.testing.assert_close(getattr(part, f)[:, chans],
                                       getattr(whole, f)[:, chans],
                                       rtol=0, atol=1e-3)
    sym = first.symbols.clone()
    sym[:, 1::2] = second.symbols[:, 1::2]
    got = tapi.extract_payloads(tapi.decode(sym.reshape(S * K, -1), cfg))
    assert got == [bytes(p) for p in payload.tolist()]


@pytest.mark.parametrize("one", [1, 1.0, Fraction(1)])
def test_slot_ratio_one_is_the_route_without_a_resampler(monkeypatch, one):
    """slot_ratio = 1 takes the filterbank straight to the demodulator, as
    before the option: the same results as the default call, the plain
    channelizer state (no pair), and no resampling."""
    cfg = radio()
    rng = np.random.default_rng(29)
    wide = (rng.standard_normal((S, K * tapi.required_samples(cfg)))
            .astype(np.complex64))
    want, wstate = tapi.channelized_demodulate(torch.as_tensor(wide), K, cfg)

    def refuse(*a, **k):
        raise AssertionError("resampled at slot_ratio 1")
    monkeypatch.setattr(trs, "weigh", refuse)
    monkeypatch.setattr(trs, "block_plan", refuse)
    got, state = tapi.channelized_demodulate(torch.as_tensor(wide), K, cfg,
                                             slot_ratio=one)
    assert isinstance(state, torch.Tensor) and torch.equal(state, wstate)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name


def test_block_plan_counts_and_carries_the_grid():
    """A block's outputs are those whose positions lie inside the samples
    delivered (floor(end / ratio) in all), the plan's first inputs relative
    to the carried tail, and a float ratio is read as the fraction."""
    dev = torch.device("cpu")
    plan, m_next, origin = trs.block_plan(None, 65536, RATIO, dev)
    assert plan.table.shape == (2, 40960) and plan.table.dtype == torch.int32
    assert (m_next, origin) == (40960, 65536 - trs.history(65536, 1.6))
    tail = torch.zeros((1, trs.history(65536, 1.6)), dtype=torch.complex64)
    st = trs.ResampleState(m_next, origin, tail)
    (table2, _), m2, o2 = trs.block_plan(st, 1001, RATIO, dev)
    assert m2 == (65536 + 1001) * 5 // 8 and table2.shape[1] == m2 - m_next
    assert int(table2[0].min()) >= 0  # inside the tail, never before it
    idx, phase = trs._plan(m_next, m2 - m_next, 1.6, trs._taps_eff(1.6))
    np.testing.assert_array_equal(table2[0].numpy(), idx[:, 0] - origin)
    np.testing.assert_array_equal(table2[1].numpy(), phase)
    assert Fraction(1.6).limit_denominator(10**6) == RATIO


@pytest.mark.parametrize("ratio", [1.6, 0.625, 0.37, 1.00005, 4.096, 16.384])
def test_kernel_r_tiles_span_at_most_their_bound(ratio):
    """Every tile of kernel R's plan spans at most the inputs its shared
    memory holds (ops/cuda_resample.geometry), at the head of a stream and
    far into one, and a block's shared memory fits the card."""
    from lora_tpu_torch.ops import cuda_resample as cr

    taps = trs._taps_eff(ratio)
    tile, span = cr.geometry(ratio, taps)
    assert 1 <= tile <= cr.TILE
    assert cr.smem(tile, span) <= cr.SMEM_MAX
    for m0 in (0, 10**7 + 3):
        start = trs._table(m0, 64 * tile + 5, ratio)[0].astype(np.int64)
        first = start[::tile]
        last = start[np.minimum(np.arange(0, start.size, tile) + tile - 1,
                                start.size - 1)]
        assert (last + taps - first).max() <= span
        assert np.all(np.diff(start) >= 0)


def _second_block_plan(ratio: Fraction, first: int, second: int):
    """The Plan of a stream's second block (`block_plan` after the state
    of a first block of `first` samples) and the first's outputs."""
    dev = torch.device("cpu")
    _, m_next, origin = trs.block_plan(None, first, ratio, dev)
    tail = torch.zeros((1, trs.history(first, float(ratio))),
                       dtype=torch.complex64)
    st = trs.ResampleState(m_next, origin, tail)
    plan, _, _ = trs.block_plan(st, second, ratio, dev)
    return plan, m_next


@pytest.mark.parametrize("case", ["8/5 head", "8/5 mid-period", "5/8 head",
                                  "5/8 mid-period", "4.096", "0.37"])
def test_kernel_r_route_from_the_plan(case):
    """The host's choice of kernel R's route from the plan table it builds
    (ops/cuda_resample.runs), the one a Plan carries: the register-blocked
    route for 8/5 (the
    US902-928 cell's 65,536 slot samples -> 40,960, and a stream's second
    block that starts mid-period) and 5/8, aligned on the table's first
    output of phase 0, every output of the table where the kernel puts it;
    the general route for 4.096 and 0.37 (periods of 125 and 100 outputs);
    every geometry's shared memory within a block's 227 KB."""
    from lora_tpu_torch.ops import cuda_resample as cr

    ratio = {"8/5": Fraction(8, 5), "5/8": Fraction(5, 8), "4.096":
             Fraction(512, 125), "0.37": Fraction(37, 100)}[case.split()[0]]
    taps = trs._taps_eff(float(ratio))
    if case.endswith("mid-period"):
        plan, m0 = _second_block_plan(ratio, 1003, 65536)
        assert m0 % ratio.denominator  # the block starts mid-period
    else:
        plan, _, _ = trs.block_plan(None, 65536, ratio, torch.device("cpu"))
        m0 = 0
    table, runs = plan.table.numpy(), plan.runs
    tile, span = cr.geometry(float(ratio), taps)
    assert cr.smem(tile, span) <= cr.SMEM_MAX
    if case in ("4.096", "0.37"):
        assert runs is None
        return
    P, Q = ratio.denominator, ratio.numerator
    assert (P, Q, taps) in cr.BLOCKED
    assert runs == cr.Runs(P, Q, taps, (-m0) % P, runs.phases,
                           cr.blocked_smem(P, Q, taps))
    assert runs.smem <= cr.SMEM_MAX
    # every output where the kernel puts it: the period's offsets and
    # phases from the aligned output, the head and tail included
    M = table.shape[1]
    m = np.arange(M) - runs.align
    k, i = np.divmod(m, P)
    start = table[0, runs.align] + k * Q + np.asarray(cr.offsets(P, Q))[i]
    np.testing.assert_array_equal(table[0], start)
    np.testing.assert_array_equal(table[1], np.asarray(runs.phases)[i])
    assert table[1, runs.align] == 0
