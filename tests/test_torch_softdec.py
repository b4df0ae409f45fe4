"""models/softdec.py against lora_tpu.models.softdec on the same numpy
spectra: every stage (word metrics, bit LLRs, LLR deinterleave, ML
codewords), soft_symbols, decode_soft and guard_soft_status.  Symbols,
statuses and bytes equal; LLRs, scores and margins within 1e-4 relative.
Every coding rate, full and reduced symbol sets, explicit and implicit
headers (the cases of tests/test_softdec.py)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lora_tpu
from lora_tpu import api as japi
from lora_tpu.models import softdec as jsoft
from lora_tpu.models.decoder import SOFT_UNVERIFIED as J_SOFT_UNVERIFIED

import lora_tpu_torch
from lora_tpu_torch import api as tapi
from lora_tpu_torch.models import softdec as tsoft
from lora_tpu_torch.ops import tables

torch.set_num_threads(1)

CASES = [
    dict(sf=7, cr="4/8"), dict(sf=7, cr="4/7"), dict(sf=7, cr="4/6"),
    dict(sf=7, cr="4/5"), dict(sf=7, cr="4/4"), dict(sf=7, cr="4/8", ppm=5),
    dict(sf=8, cr="4/6", ppm=6), dict(sf=8, cr="4/5", explicit_header=False),
    dict(sf=7, cr="4/8", crc=False),
]
IDS = ["-".join(f"{k}{v}" for k, v in c.items()).replace("/", "") for c in CASES]
RTOL = 1e-4


def _cfgs(fields, L=12, extra=4):
    """(JAX config, port config) from one dict, mtu = the frame + extra."""
    fields = dict(fields, ampl=1.0, data_length=L)
    j = lora_tpu.LoRaConfig(**fields)
    mtu = j.num_symbols(L) + extra
    return j.replace(mtu=mtu), lora_tpu_torch.LoRaConfig(**fields, mtu=mtu)


def _spectra(cfg, rng, B, L, noise):
    """|FFT|^2-like windows [B, mtu, N]: a peak of N^2 at each frame's
    symbols over exponential noise, the mtu padding slots exactly zero (as
    an all-zero buffer tail gives), and the payloads."""
    payload = rng.integers(0, 256, (B, L)).astype(np.uint8)
    sym = tapi.encode(payload, cfg, device="cpu").numpy()
    S, N = sym.shape[1], cfg.N
    mag2 = np.zeros((B, cfg.mtu, N), np.float32)
    mag2[:, :S] = noise * N * rng.exponential(1.0, (B, S, N))
    b, s = np.meshgrid(np.arange(B), np.arange(S), indexing="ij")
    mag2[b, s, sym] += N * N
    return mag2, payload


def _close(got, want, what):
    want = np.asarray(want)
    scale = np.abs(want[np.isfinite(want)]).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * scale, err_msg=what)


@pytest.mark.parametrize("sf,ppm", [(7, 7), (7, 5), (8, 6), (10, 10), (12, 9)])
def test_bin_word_gather_table(sf, ppm):
    want = jsoft._bin_word_gather(sf, ppm)
    got = tables.bin_word_gather(sf, ppm)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fields", CASES, ids=IDS)
def test_stages_match_jax(fields):
    jcfg, tcfg = _cfgs(fields)
    rng = np.random.default_rng(5)
    mag2, _ = _spectra(tcfg, rng, 3, 12, noise=40.0)
    ppm, rdd = tcfg.PPM, tcfg.rdd

    jm = jsoft._word_metrics(jnp.asarray(mag2), jcfg)
    tm = tsoft._word_metrics(torch.as_tensor(mag2), tcfg)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))  # a gather + max

    jl = jsoft._bit_llrs(jm, ppm)
    tl = tsoft._bit_llrs(tm, ppm)
    assert tl.shape == (3, tcfg.mtu, ppm)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))  # max, subtract

    nbits = 4 + rdd
    nsym = (tcfg.mtu // nbits) * nbits
    jd = jsoft._deinterleave_llrs(jl[:, :nsym], ppm, rdd)
    td = tsoft._deinterleave_llrs(tl[:, :nsym], ppm, rdd)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))

    n = td.shape[-2]
    stream = (rng.integers(0, 256, n) & ((1 << nbits) - 1)).astype(np.int32)
    jcw, jmargin = jsoft._ml_codewords(jd, jnp.asarray(stream), rdd)
    tcw, tmargin = tsoft._ml_codewords(td, torch.as_tensor(stream), rdd)
    np.testing.assert_array_equal(tcw.numpy(), np.asarray(jcw))
    _close(tmargin, jmargin, "margin")


def test_ml_codewords_ties_take_the_first_candidate():
    """All-zero LLRs (the mtu padding slots) score 0 on all 16 candidates:
    both frameworks keep candidate 0, enc(0) ^ stream = stream."""
    stream = np.arange(10, dtype=np.int32)
    llr = np.zeros((2, 10, 8), np.float32)
    jcw, jm = jsoft._ml_codewords(jnp.asarray(llr), jnp.asarray(stream), 4)
    tcw, tm = tsoft._ml_codewords(torch.as_tensor(llr),
                                  torch.as_tensor(stream), 4)
    np.testing.assert_array_equal(tcw.numpy(), np.asarray(jcw))
    np.testing.assert_array_equal(tcw.numpy(), np.broadcast_to(stream, (2, 10)))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("noise", [0.0, 60.0])
@pytest.mark.parametrize("fields", CASES, ids=IDS)
def test_soft_symbols_and_decode_match_jax(fields, noise):
    jcfg, tcfg = _cfgs(fields)
    rng = np.random.default_rng(11)
    B, L = 6, 12
    mag2, payload = _spectra(tcfg, rng, B, L, noise)
    jsym, jmargin = jsoft.soft_symbols(jnp.asarray(mag2), jcfg)
    tsym, tmargin = tsoft.soft_symbols(torch.as_tensor(mag2), tcfg)
    assert tsym.dtype == torch.int32
    np.testing.assert_array_equal(tsym.numpy(), np.asarray(jsym))
    _close(tmargin, jmargin, "margin")

    jdec = jsoft.decode_soft(jnp.asarray(mag2), jcfg)
    tdec = tapi.decode_soft(mag2, tcfg, device="cpu")
    for f in dataclasses.fields(tdec):
        np.testing.assert_array_equal(getattr(tdec, f.name).numpy(),
                                      np.asarray(getattr(jdec, f.name)),
                                      err_msg=f.name)
    got = tapi.extract_payloads(tdec)
    assert got == japi.extract_payloads(jdec)
    if noise == 0.0:
        # without a CRC the reference's explicit-header quirk reports
        # packetLength - 2 bytes (models/decoder.py)
        cut = L if tcfg.crc or not tcfg.explicit_header else L - 2
        assert got == [bytes(p[:cut]) for p in payload.tolist()]
    # num_symbols shorter and longer than the windows given
    for ns in (tcfg.mtu - 5, tcfg.mtu + 3):
        jsym, _ = jsoft.soft_symbols(jnp.asarray(mag2), jcfg, ns)
        tsym, _ = tapi.soft_symbols(torch.as_tensor(mag2), tcfg, ns)
        np.testing.assert_array_equal(tsym.numpy(), np.asarray(jsym))


def test_soft_decoding_needs_interleaving():
    cfg = lora_tpu_torch.LoRaConfig(sf=7, interleaving=False, mtu=8)
    with pytest.raises(ValueError, match="interleaving"):
        tapi.decode_soft(torch.zeros((1, 8, 128)), cfg)


def test_soft_beats_hard_on_weak_spectra():
    """At a noise level where single bins flip, ML selection over the whole
    spectrum recovers frames the hard argmax loses; both packages count the
    same frames."""
    jcfg, tcfg = _cfgs(dict(sf=7, cr="4/8"), L=12, extra=0)
    rng = np.random.default_rng(2)
    B = 32
    mag2, payload = _spectra(tcfg, rng, B, 12, noise=16.0)
    want = [bytes(p) for p in payload.tolist()]
    hard = tapi.extract_payloads(
        tapi.decode(torch.as_tensor(mag2).argmax(-1), tcfg))
    soft = tapi.extract_payloads(tapi.decode_soft(torch.as_tensor(mag2), tcfg))
    jsoft_got = japi.extract_payloads(jsoft.decode_soft(jnp.asarray(mag2), jcfg))
    assert soft == jsoft_got
    n_hard = sum(h == w for h, w in zip(hard, want))
    n_soft = sum(s == w for s, w in zip(soft, want))
    assert n_soft > n_hard, (n_soft, n_hard)


def test_guard_soft_status_matches_jax():
    """CRC-less frames (tests/test_softdec.py:151): a soft OK that the hard
    decode does not confirm becomes SOFT_UNVERIFIED; a clean frame and every
    CRC-bearing frame keep their status."""
    assert tapi.SOFT_UNVERIFIED == J_SOFT_UNVERIFIED
    assert tapi.STATUS_NAMES[tapi.SOFT_UNVERIFIED] == "soft_unverified"
    for crc in (False, True):
        jcfg, tcfg = _cfgs(dict(sf=7, cr="4/8", crc=crc, crc_check=crc),
                           L=12, extra=0)
        rng = np.random.default_rng(9)
        B = 8
        mag2, _ = _spectra(tcfg, rng, B, 12, noise=0.0)
        # frames 4..7: payload windows past the header block become noise
        mag2[4:, 8:] = rng.exponential(1.0, mag2[4:, 8:].shape)
        hard_sym = mag2.argmax(-1).astype(np.int32)
        jgot = jsoft.guard_soft_status(
            jsoft.decode_soft(jnp.asarray(mag2), jcfg),
            japi.decode(jnp.asarray(hard_sym), jcfg))
        tgot = tapi.guard_soft_status(
            tapi.decode_soft(torch.as_tensor(mag2), tcfg),
            tapi.decode(torch.as_tensor(hard_sym), tcfg))
        assert isinstance(tgot, np.ndarray)
        np.testing.assert_array_equal(tgot, jgot)
        assert (tgot[:4] == tapi.OK).all()
        if not crc:
            assert (tgot[4:] == tapi.SOFT_UNVERIFIED).all()
        else:
            assert (tgot[4:] != tapi.OK).all()
