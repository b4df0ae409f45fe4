"""The transmit half of the port against lora_tpu on the CPU: kernel F's
index math (csrc/modulate.cu) replayed in numpy, the frame head built once
per config on the host, encode over its options, and the program bodies of
encode, modulate and dcblock reading nothing back from their device.

model_frame replays what one launch of kernel F computes for a bank: the
grid of (sample chunk, row) blocks, each block's symbol end carries and
their exclusive prefix sum as its threads and warps form it (uint32 sums
that wrap), and each sample's source: the head, a data numerator, or zero.
Its constants are read from the source.  The numerators must equal
lora_tpu's (its `_phase_nums` under vmap and its uint32 cumsum,
lora_tpu/models/modulator.py:89-98) bit for bit, and the IQ they give
through the plain route's float32 sequence must be within 1e-5 of
lora_tpu's modulate (tests/test_torch_modulate.py's bar: cos and sin of the
same float32 angle in two libraries)."""

import math
import pathlib
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

import lora_tpu
from lora_tpu import api as japi
from lora_tpu.models import modulator as jmod
from lora_tpu.ops import cplx as jcplx

import lora_tpu_torch
from lora_tpu_torch import api as tapi
from lora_tpu_torch.models import encoder as tenc
from lora_tpu_torch.models import modulator as tmod
from lora_tpu_torch.ops import _cuda, chirp, cuda_modulate
from lora_tpu_torch.ops import dcblock as tdc

torch.set_num_threads(1)

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "lora_tpu_torch"
          / "csrc" / "modulate.cu").read_text()


def const(name: str) -> int:
    return int(re.search(r"constexpr int %s = (\d+);" % name,
                         SOURCE).group(1))


THREADS, ITEMS = const("kModThreads"), const("kModItems")
CHUNKS = const("kModChunks")


def test_source_constants():
    assert THREADS % 32 == 0 and THREADS // 32 <= 32  # one warp scans wsum
    assert const("kMaxSymbols") == cuda_modulate.MAX_SYMBOLS
    assert 16 * cuda_modulate.MAX_SYMBOLS + 4 * (THREADS // 32) <= 232448
    assert cuda_modulate.TWO_PI == float(np.float32(2 * math.pi))


def sym_terms(s, N, ovs):
    """csrc/modulate.cu sym_terms: (A, c, thr clamped to [0, NN + 2])."""
    u = np.uint32
    D = N * ovs * ovs
    thr = ovs * (N - s.astype(np.int64))
    A = s.astype(u) * u(ovs) + u((2 * D - N * ovs // 2) % D)
    c = (-thr).astype(u) * u((D - N * ovs % D) % D)
    return A, c, np.clip(thr, 0, N * ovs + 2)


def phase_num(s, i1, N, ovs):
    """csrc/modulate.cu phase_num in uint32 (s int32, i1 uint32 arrays)."""
    u = np.uint32
    D = N * ovs * ovs
    A, c, thr = sym_terms(s, N, ovs)
    tri = ((i1 * (i1 + u(1))) & u(2 * D - 1)) >> u(1)
    wrapped = np.where(i1.astype(np.int64) + 1 > thr,
                       (i1 + u(1)) * u((D - N * ovs % D) % D) + c, u(0))
    return i1 * A + tri + wrapped.astype(u)


def block_starts(row, head_carry, N, ovs):
    """One block's starts of its row's symbols, as its threads form them:
    thread t a run of `per` symbols, inclusive warp sums, the warps' totals
    scanned by warp 0, then each run from the head's carry."""
    u = np.uint32
    S = row.size
    D = N * ovs * ovs
    NN = N * ovs
    carry = phase_num(row, np.full(S, NN, u), N, ovs) & u(D - 1)
    per = -(-S // THREADS)
    lo = [min(S, t * per) for t in range(THREADS)]
    hi = [min(S, lo[t] + per) for t in range(THREADS)]
    local = np.array([carry[lo[t]:hi[t]].sum(dtype=u) for t in range(THREADS)],
                     u)
    warps = local.reshape(-1, 32)
    incl = np.cumsum(warps, axis=1, dtype=u).reshape(-1)
    wsum = np.cumsum(incl.reshape(-1, 32)[:, 31], dtype=u)
    starts = np.zeros(S, u)
    for t in range(THREADS):
        w = t // 32
        run = u(head_carry) + (wsum[w - 1] if w else u(0)) + incl[t] - local[t]
        for j in range(lo[t], hi[t]):
            starts[j] = run & u(D - 1)
            run = run + carry[j]
    return starts


def model_frame(syms, H, head_carry, N, ovs, padding):
    """kernel F's output map for a bank syms int32 [B, S]: (kind [B, T] of
    0 head, 1 data, 2 zero; value [B, T]: the head index or the data
    numerator).  Every (block, item, thread) writes one sample, each sample
    once."""
    u = np.uint32
    B, S = syms.shape
    NN, D = N * ovs, N * ovs * ovs
    T = H + (S + padding) * NN
    chunk = THREADS * ITEMS
    kind = np.full((B, T), -1, np.int64)
    value = np.zeros((B, T), np.int64)
    grid_y = min(B, 65535)
    tid = np.arange(THREADS)
    runs = [(bx, r, k) for bx in range(-(-T // (chunk * CHUNKS)))
            for r in range(CHUNKS) for k in range(ITEMS)]
    for by in range(grid_y):
        for b in range(by, B, grid_y):
            starts = block_starts(syms[b], head_carry, N, ovs)
            for bx, r, k in runs:
                t = bx * chunk * CHUNKS + r * chunk + k * THREADS + tid
                t = t[t < T]
                assert (kind[b, t] == -1).all()  # written once
                head = t < H
                data = (t >= H) & (t < H + S * NN)
                d = (t[data] - H).astype(u)
                j = (d >> u(int(math.log2(NN)))).astype(np.int64)
                i1 = (d & u(NN - 1)) + u(1)
                num = (phase_num(syms[b, j], i1, N, ovs) + starts[j]) \
                    & u(D - 1)
                kind[b, t] = np.where(head, 0, np.where(data, 1, 2))
                value[b, t[head]] = t[head]
                value[b, t[data]] = num
    assert (kind >= 0).all()
    return kind, value


def jax_frame_nums(syms, cfg):
    """lora_tpu's numerators of a bank: its head and its data symbols'
    (modulator.py:89-98, the same ops)."""
    N, ovs, NN = cfg.N, cfg.ovs, cfg.NN
    D = N * ovs * ovs
    head, head_carry = jmod.preamble_nums(cfg)
    nums, carries = jax.vmap(jax.vmap(
        lambda s: jmod._phase_nums(s, NN, N, ovs, False)))(
            jnp.asarray(syms, jnp.int32))
    starts = jnp.cumsum(carries, axis=-1, dtype=jnp.uint32) - carries
    starts = (starts + head_carry) & np.uint32(D - 1)
    nums = (nums + starts[..., None]) & np.uint32(D - 1)
    return np.asarray(head), int(head_carry), np.asarray(nums).reshape(
        syms.shape[0], -1)


def check_model(cfg, syms):
    jcfg = lora_tpu.LoRaConfig(**cfg)
    tcfg = lora_tpu_torch.LoRaConfig(**cfg)
    head, head_carry, data = jax_frame_nums(syms, jcfg)
    tnums, tcarry = tmod.preamble_nums(tcfg, "cpu")
    np.testing.assert_array_equal(tnums.numpy(), head)
    assert tcarry == head_carry
    H = head.size
    kind, value = model_frame(syms.astype(np.int32), H, tcarry, tcfg.N,
                              tcfg.ovs, tcfg.padding)
    B, S = syms.shape
    assert kind.shape == (B, tcfg.frame_samples(S))
    NN = tcfg.NN
    assert (kind[:, :H] == 0).all() and (value[:, :H] == np.arange(H)).all()
    assert (kind[:, H:H + S * NN] == 1).all()
    assert (kind[:, H + S * NN:] == 2).all()
    np.testing.assert_array_equal(value[:, H:H + S * NN], data)
    return jcfg, tcfg, kind, value


@pytest.mark.parametrize("pre", [8, 12])
@pytest.mark.parametrize("ovs", [1, 2])
@pytest.mark.parametrize("sf", range(7, 13))
def test_kernel_f_model_matches_jax_numerators(sf, ovs, pre):
    rng = np.random.default_rng(100 * sf + 10 * ovs + pre)
    for sync in (0x12, 0x3C):
        cfg = dict(sf=sf, cr="4/8", ovs=ovs, preamble_symbols=pre, sync=sync,
                   ampl=0.7)
        S = int(rng.integers(9, 24))
        syms = rng.integers(0, 1 << sf, (2, S))
        syms[0, :3] = [0, 1, (1 << sf) - 1]   # the wrap's edges
        check_model(cfg, syms)


@pytest.mark.parametrize("N,ovs", [(128, 1), (1024, 2), (4096, 8)])
def test_kernel_f_terms_match_the_plain_route_for_any_int32_symbol(N, ovs):
    """The wrap's clamped threshold and its offset c keep the plain route's
    numerators for symbols outside [0, N) too (negative ones, and ones past
    N whose wrap comes at once)."""
    D, NN = N * ovs * ovs, N * ovs
    syms = np.array([0, 1, N - 1, N, N + 3, -1, -N, 2 ** 20, -2 ** 20,
                     2 ** 31 - 1, -2 ** 31], np.int64)
    want, carry = chirp.chirp_phase_nums(syms, NN, N, ovs, device="cpu")
    i1 = np.arange(1, NN + 1, dtype=np.uint32)
    got = np.stack([phase_num(np.full(NN, s).astype(np.int32), i1, N, ovs)
                    for s in syms]) & np.uint32(D - 1)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got[:, -1], carry.numpy())


def test_kernel_f_model_iq_at_a_255_byte_payload():
    """A 255-byte payload at SF7 CR 4/8 (a symbol run that spans several
    threads of the scan), its IQ through the plain route's float32
    sequence against lora_tpu's modulate."""
    cfg = dict(sf=7, cr="4/8", ampl=0.5)
    rng = np.random.default_rng(255)
    payload = rng.integers(0, 256, (2, 255)).astype(np.uint8)
    syms = tapi.encode(payload, lora_tpu_torch.LoRaConfig(**cfg),
                       device="cpu").numpy()
    assert syms.shape[1] > THREADS
    jcfg, tcfg, kind, value = check_model(cfg, syms)
    head = tmod.frame_head(tcfg, torch.device("cpu")).numpy()
    D = tcfg.N * tcfg.ovs ** 2
    ang = (value.astype(np.float32) / np.float32(D)) * np.float32(2 * math.pi)
    iq = (np.cos(ang) * np.float32(0.5)) + 1j * (np.sin(ang) * np.float32(0.5))
    iq = np.where(kind == 0, head[np.minimum(value, head.size - 1)], iq)
    iq = np.where(kind == 2, 0, iq).astype(np.complex64)
    want = jcplx.to_complex(japi.modulate(jnp.asarray(syms), jcfg))
    np.testing.assert_allclose(iq, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        tmod.modulate(syms, tcfg, device="cpu")[:, :head.size].numpy(),
        np.broadcast_to(head, (2, head.size)))


def old_preamble_nums(cfg):
    """preamble_nums as the port built it before: segment by segment from
    chirp_phase_nums, the carry read back with int()."""
    N, ovs, NN = cfg.N, cfg.ovs, cfg.NN
    D = N * ovs * ovs
    plan = ([(0, NN, False)] * cfg.preamble_symbols
            + [((cfg.sync >> 4) * 8, NN, False),
               ((cfg.sync & 0xF) * 8, NN, False)]
            + [(0, NN, True), (0, NN, True), (0, NN // 4, True)])
    segs, carry = [], 0
    for s, n, down in plan:
        num, end = chirp.chirp_phase_nums(s, n, N, ovs, down, device="cpu")
        segs.append((num + carry) & (D - 1))
        carry = (carry + int(end)) & (D - 1)
    return torch.cat(segs), carry


@pytest.mark.parametrize("sf,ovs,pre,sync", [(7, 1, 10, 0x12),
                                             (9, 4, 6, 0x34),
                                             (12, 2, 12, 0xF0),
                                             (10, 8, 8, 0x00)])
def test_preamble_table_once_a_device_and_bit_equal_to_the_old(sf, ovs, pre,
                                                               sync):
    cfg = lora_tpu_torch.LoRaConfig(sf=sf, ovs=ovs, preamble_symbols=pre,
                                    sync=sync)
    nums, carry = tmod.preamble_nums(cfg, "cpu")
    again, carry2 = tmod.preamble_nums(cfg, torch.device("cpu"))
    assert again is nums and carry2 == carry and isinstance(carry, int)
    old, old_carry = old_preamble_nums(cfg)
    assert nums.dtype == torch.int64 and torch.equal(nums, old)
    assert carry == old_carry
    head = tmod.frame_head(cfg, torch.device("cpu"))
    assert head is tmod.frame_head(cfg, torch.device("cpu"))
    assert head.shape == (cfg.frame_samples(0) - cfg.padding * cfg.NN,)


def no_kernel():
    raise AssertionError("the CPU route loaded the kernels' library")


def test_modulate_is_its_plain_route_on_the_cpu(monkeypatch):
    cfg = lora_tpu_torch.LoRaConfig(sf=8, cr="4/6", ampl=0.3, ovs=2)
    syms = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (3, 17)))
    monkeypatch.setattr(_cuda, "library", no_kernel)  # no kernel on the CPU
    got = tmod.modulate(syms, cfg)
    assert torch.equal(got, tmod.modulate_plain(syms, cfg))
    assert torch.equal(tmod.modulate(syms[1], cfg), got[1])
    assert got.dtype == torch.complex64 and got.device.type == "cpu"


def test_frame_wrapper_refuses_what_the_kernel_does_not_take():
    head = torch.zeros(16, dtype=torch.complex64)
    meta = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_modulate.frame(meta, head, 0, 64, 1, 0, 1.0)


# ---------------------------------------------------------------------------
# the program bodies read nothing back
# ---------------------------------------------------------------------------

READS = ("item", "__int__", "__float__", "__bool__", "__index__", "tolist",
         "cpu", "numpy")


@pytest.fixture
def no_readback(monkeypatch):
    """Every way a tensor's values reach the host raises."""

    def refuse(name):
        def read(self, *a, **k):
            raise AssertionError(f"Tensor.{name} called: a host sync")
        return read

    def arm():
        for name in READS:
            monkeypatch.setattr(torch.Tensor, name, refuse(name))

    return arm


def test_program_bodies_read_nothing_back(no_readback):
    cfg = lora_tpu_torch.LoRaConfig(sf=7, cr="4/5", ampl=0.8, ovs=2,
                                    preamble_symbols=9)
    rng = np.random.default_rng(5)
    pay = torch.from_numpy(rng.integers(0, 256, (3, 11)).astype(np.uint8))
    x = torch.from_numpy((rng.standard_normal((2, 3000))
                          + 1j * rng.standard_normal((2, 3000))).astype(
                              np.complex64))
    c = torch.zeros(2)
    cpu = torch.device("cpu")
    syms = tenc._encode(pay, cfg, 11, cpu)
    want = (syms, tmod.modulate(syms, cfg, cpu),
            tdc._dcblock(x, 0.999, c, c, cpu))
    # the head's table is built on the host once per config; its upload
    # and its IQ on the device run under the guard
    tmod.frame_head.cache_clear()
    no_readback()
    got = (tenc._encode(pay, cfg, 11, cpu),
           tmod.modulate(syms, cfg, cpu),
           tdc._dcblock(x, 0.999, c, c, cpu),
           tdc._dcblock(x, 0.99, None, None, cpu))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# encode over its options
# ---------------------------------------------------------------------------

@settings(max_examples=24, deadline=None)
@given(payload_len=st.integers(1, 40), cr=st.sampled_from(["4/5", "4/6",
                                                           "4/7", "4/8"]),
       header=st.booleans(), crc=st.booleans(), sf=st.sampled_from([7, 8]),
       extra=st.integers(0, 3), seed=st.integers(0, 2 ** 16))
def test_encode_options_match_jax(payload_len, cr, header, crc, sf, extra,
                                  seed):
    """Bytes past payload_len take no part; every option bit-equal."""
    kw = dict(sf=sf, cr=cr, explicit_header=header, crc=crc)
    if not header:
        kw["data_length"] = payload_len
    payload = np.random.default_rng(seed).integers(
        0, 256, (2, payload_len + extra)).astype(np.uint8)
    want = np.asarray(japi.encode(jnp.asarray(payload),
                                  lora_tpu.LoRaConfig(**kw), payload_len))
    got = tapi.encode(payload, lora_tpu_torch.LoRaConfig(**kw), payload_len,
                      device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
