"""The port's own copies of the JAX package's jax-free modules: LoRaConfig
(lora_tpu_torch/config.py against lora_tpu/config.py) and the scalar
bit-level codecs (lora_tpu_torch/ops/_bitref.py against
lora_tpu/ops/_bitref.py, loaded by path so that lora_tpu/ops/__init__.py is
not run for it)."""

import dataclasses
import importlib.util
import itertools
import pathlib

import numpy as np
import pytest

import lora_tpu
import lora_tpu.config as jconfig

import lora_tpu_torch
import lora_tpu_torch.config as tconfig
from lora_tpu_torch.ops import _bitref as tbit

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load_jax_bitref():
    path = REPO / "lora_tpu" / "ops" / "_bitref.py"
    spec = importlib.util.spec_from_file_location("_jax_bitref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbit = _load_jax_bitref()


def test_config_is_the_ports_own_class():
    assert lora_tpu_torch.LoRaConfig is tconfig.LoRaConfig
    assert lora_tpu_torch.LoRaConfig is not lora_tpu.LoRaConfig
    from lora_tpu_torch import api

    assert api.LoRaConfig is tconfig.LoRaConfig


def test_config_fields_defaults_constants():
    jf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(jconfig.LoRaConfig)]
    tf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(tconfig.LoRaConfig)]
    assert jf == tf
    assert dataclasses.asdict(jconfig.LoRaConfig()) == dataclasses.asdict(
        tconfig.LoRaConfig())
    for name in ("CODING_RATES", "HEADER_RDD", "N_HEADER_SYMBOLS",
                 "N_HEADER_CODEWORDS"):
        assert getattr(jconfig, name) == getattr(tconfig, name), name
    assert lora_tpu_torch.CODING_RATES == jconfig.CODING_RATES
    # frozen and hashable, as caches keyed by a config need
    cfg = tconfig.LoRaConfig(sf=8)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.sf = 9
    assert hash(cfg) == hash(tconfig.LoRaConfig(sf=8))
    assert cfg.replace(cr="4/5") == tconfig.LoRaConfig(sf=8, cr="4/5")


@pytest.mark.parametrize("sf", range(6, 13))
def test_config_derived_values(sf):
    for cr, ppm_cut, explicit, crc, ovs in itertools.product(
            jconfig.CODING_RATES, (0, 2), (True, False), (True, False),
            (1, 4)):
        fields = dict(sf=sf, cr=cr, ppm=sf - ppm_cut if ppm_cut else 0,
                      explicit_header=explicit, crc=crc, ovs=ovs,
                      preamble_symbols=6 + sf, padding=sf % 3)
        j = lora_tpu.LoRaConfig(**fields)
        t = lora_tpu_torch.LoRaConfig(**fields)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for prop in ("N", "NN", "PPM", "rdd"):
            assert getattr(j, prop) == getattr(t, prop), prop
        for L in (0, 1, 7, 16, 255):
            assert j.num_codewords(L) == t.num_codewords(L)
            assert j.num_symbols(L) == t.num_symbols(L)
            assert j.frame_samples(j.num_symbols(L)) == t.frame_samples(
                t.num_symbols(L))


@pytest.mark.parametrize("fields", [
    dict(sf=5), dict(sf=13), dict(cr="4/9"), dict(cr="4/3"), dict(ovs=0),
    dict(ovs=257), dict(sf=7, ppm=8), dict(preamble_symbols=5),
])
def test_config_errors(fields):
    with pytest.raises(ValueError) as jerr:
        lora_tpu.LoRaConfig(**fields)
    with pytest.raises(ValueError) as terr:
        lora_tpu_torch.LoRaConfig(**fields)
    assert str(jerr.value) == str(terr.value)


def test_bitref_scalar_codecs():
    assert (tbit.HEADER_RDD, tbit.N_HEADER_SYMBOLS, tbit.N_HEADER_CODEWORDS) \
        == (jbit.HEADER_RDD, jbit.N_HEADER_SYMBOLS, jbit.N_HEADER_CODEWORDS)
    for n in range(16):
        for f in ("encode_hamming84", "encode_hamming74", "encode_parity54",
                  "encode_parity64"):
            assert getattr(tbit, f)(n) == getattr(jbit, f)(n), (f, n)
    for c in range(256):
        for f in ("decode_hamming84", "decode_hamming74", "check_parity54",
                  "check_parity64"):
            assert getattr(tbit, f)(c) == getattr(jbit, f)(c), (f, c)
    for v in list(range(300)) + [0xFFFF, 0x8000, 0x1234]:
        assert tbit.binary_to_gray16(v) == jbit.binary_to_gray16(v)
        assert tbit.gray_to_binary16(v) == jbit.gray_to_binary16(v)
        assert tbit.round_up(v, 7) == jbit.round_up(v, 7)


def test_bitref_streams():
    rng = np.random.default_rng(0)
    for mode in (False, True):
        assert tbit.whitening_sequence(600, mode) == jbit.whitening_sequence(
            600, mode)
    for rdd in range(5):
        buf = rng.integers(0, 1 << (4 + rdd), 40).tolist()
        assert tbit.whiten(buf, 3, rdd) == jbit.whiten(buf, 3, rdd)
        for ppm in (6, 7, 10, 12):
            cw = rng.integers(0, 1 << (4 + rdd), 3 * ppm).tolist()
            sym = tbit.diagonal_interleave(cw, ppm, rdd)
            assert sym == jbit.diagonal_interleave(cw, ppm, rdd)
            assert tbit.diagonal_deinterleave(sym, ppm, rdd) == \
                jbit.diagonal_deinterleave(sym, ppm, rdd) == cw
    for h0, h1 in rng.integers(0, 256, (50, 2)).tolist():
        assert tbit.header_checksum(h0, h1 & 0xF) == jbit.header_checksum(
            h0, h1 & 0xF)
    for n in (0, 1, 5, 64, 255):
        data = rng.integers(0, 256, n).tolist()
        assert tbit.sx1272_data_checksum(data) == jbit.sx1272_data_checksum(
            data)
