"""The port's constant tables (lora_tpu_torch/ops/tables.py) against the JAX
package's, plus the reference oracle's golden vectors
(tests/golden/golden.json) run through the port's codecs and detector."""

import json
import pathlib

import numpy as np
import pytest
import torch

import lora_tpu
from lora_tpu.models import demodulator as jdemod
from lora_tpu.ops import chirp as jchirp
from lora_tpu.ops import codes as jcodes
from lora_tpu.ops import fft as jfft
from lora_tpu.ops import pallas_demod

from lora_tpu_torch.models import demodulator as tdemod
from lora_tpu_torch.models.encoder import encode
from lora_tpu_torch.ops import chirp, codes, cplx, detect, tables

torch.set_num_threads(1)

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "golden.json").read_text()
)


def golden_iq(key):
    flat = np.asarray(GOLDEN[key], np.float64)
    return (flat[0::2] + 1j * flat[1::2]).astype(np.complex64)


def test_codec_tables_equal_jax():
    np.testing.assert_array_equal(tables.ENC_LUTS, jcodes.ENC_LUTS)
    np.testing.assert_array_equal(tables.DEC_LUTS, jcodes.DEC_LUTS)
    np.testing.assert_array_equal(tables.WHITEN_SEQ, jcodes.WHITEN_SEQ)
    x = torch.arange(1 << 12)
    np.testing.assert_array_equal(
        codes.binary_to_gray(x).numpy(),
        np.asarray(jcodes.binary_to_gray(np.arange(1 << 12))),
    )
    np.testing.assert_array_equal(
        codes.gray_to_binary(x).numpy(),
        np.asarray(jcodes.gray_to_binary(np.arange(1 << 12))),
    )
    for ppm in range(7, 13):
        for rdd in range(5):
            np.testing.assert_array_equal(
                tables.interleave_gather(ppm, rdd),
                jcodes._interleave_gather(ppm, rdd),
            )


@pytest.mark.parametrize("down", [False, True])
def test_dechirp_tables_equal_jax(down):
    for sf in range(6, 13):
        N = 1 << sf
        np.testing.assert_array_equal(
            tables.dechirp_turns_np(N, down), jchirp._dechirp_turns_np(N, down)
        )
        for mine, theirs in zip(tables.dechirp_table_np(N, down),
                                jchirp._dechirp_table_np(N, down)):
            np.testing.assert_array_equal(mine, theirs)


def test_dft_and_twiddle_tables_equal_jax():
    for n in (8, 16, 32, 128, 256):
        for mine, theirs in zip(tables.dft_matrix_np(n), jfft._dft_matrix_np(n)):
            np.testing.assert_array_equal(mine, theirs)
    for n1, n2 in ((4, 128), (8, 128), (32, 128), (2, 512), (2, 2048)):
        for mine, theirs in zip(tables.twiddle_np(n1, n2),
                                jfft._twiddle_np(n1, n2)):
            np.testing.assert_array_equal(mine, theirs)
    # the kernels' radix-2 twiddles are exp(-2*pi*i*k/N), k < N/2
    for N in (64, 1024, 4096):
        tw = tables.fft_twiddles_np(N)
        k = np.arange(N // 2)
        np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1],
                                   np.exp(-2j * np.pi * k / N), atol=1e-7)


def test_geometry_helpers_equal_jax():
    assert tables.TRACK_ROWS == pallas_demod.TRACK_ROWS
    assert tables.N_SCAN == pallas_demod.N_SCAN
    assert tables.N_TRACK_WIN == pallas_demod.N_TRACK_WIN
    for sf in range(6, 13):
        N = 1 << sf
        for mtu in (7, 16, 20, 24, 33, 40, 64, 68, 129, 136, 256):
            assert tables.payload_geometry(N, mtu) == \
                pallas_demod.payload_geometry(N, mtu)
            assert tables.payload_flat_geometry(N, mtu) == \
                pallas_demod.payload_flat_geometry(N, mtu)
            assert tables.payload_rows(N, mtu) == \
                pallas_demod.payload_rows(N, mtu)


@pytest.mark.parametrize("sf", range(6, 13))
def test_required_samples_equal_jax(sf):
    for cr, mtu, pre in (("4/8", 20, 10), ("4/5", 68, 10), ("4/7", 256, 8),
                         ("4/6", 33, 6)):
        cfg = lora_tpu.LoRaConfig(sf=sf, cr=cr, mtu=mtu, preamble_symbols=pre)
        assert tdemod.required_samples(cfg) == jdemod.required_samples(cfg)


def test_golden_codec_vectors():
    for rdd in range(5):
        lfsr = GOLDEN[f"whiten_lfsr_rdd{rdd}"]
        mine = codes.whiten(torch.zeros(len(lfsr), dtype=torch.int64), 0, rdd)
        np.testing.assert_array_equal(mine.numpy(), lfsr)
    for ofs in (1, 7, 12):
        lfsr = GOLDEN[f"whiten_lfsr_rdd4_ofs{ofs}"]
        mine = codes.whiten(torch.zeros(len(lfsr), dtype=torch.int64), ofs, 4)
        np.testing.assert_array_equal(mine.numpy(), lfsr)
    for i, length in enumerate([0, 1, 2, 5, 16, 64, 255]):
        data = torch.as_tensor(GOLDEN[f"crc_payload_len{length}"],
                               dtype=torch.int64).reshape(1, -1)
        crc = int(codes.sx1272_data_checksum(data)[0])
        assert crc & 0xFF == GOLDEN["crc_lo"][i]
        assert crc >> 8 == GOLDEN["crc_hi"][i]
    h0 = torch.arange(0, 256, 7)[:, None].expand(-1, 6).reshape(-1)
    h1 = torch.arange(0, 16, 3)[None, :].expand(37, -1).reshape(-1)
    assert codes.header_checksum(h0, h1).tolist() == GOLDEN["header_checksums"]
    nibs = torch.arange(16)
    for rdd, key in ((4, "enc_hamming84"), (3, "enc_hamming74"),
                     (1, "enc_parity54"), (2, "enc_parity64")):
        assert codes.fec_encode(nibs, rdd).tolist() == GOLDEN[key]
    for ppm in range(7, 13):
        for rdd in range(5):
            cw = torch.as_tensor(GOLDEN[f"il_cw_ppm{ppm}_rdd{rdd}"])
            sym = codes.interleave(cw[None], ppm, rdd)[0]
            assert sym.tolist() == GOLDEN[f"il_sym_ppm{ppm}_rdd{rdd}"]


def test_golden_encoder_symbols():
    payload = np.asarray(GOLDEN["enc_payload"], np.uint8)[None]
    for sf in range(7, 13):
        for rdd in range(5):
            cfg = lora_tpu.LoRaConfig(sf=sf, cr=f"4/{4 + rdd}")
            assert encode(payload, cfg)[0].tolist() == \
                GOLDEN[f"enc_symbols_sf{sf}_rdd{rdd}"]
    for cfg, key in (
        (lora_tpu.LoRaConfig(sf=11, ppm=9, cr="4/7"),
         "enc_symbols_sf11_ppm9_rdd3"),
        (lora_tpu.LoRaConfig(sf=10, cr="4/8", explicit_header=False,
                             crc=False), "enc_symbols_implicit_nocrc"),
        (lora_tpu.LoRaConfig(sf=10, cr="4/8", whitening=False),
         "enc_symbols_nowhiten"),
        (lora_tpu.LoRaConfig(sf=10, cr="4/5"), "enc_symbols_rdd1"),
    ):
        assert encode(payload, cfg)[0].tolist() == GOLDEN[key]


@pytest.mark.parametrize(
    "key,N,ovs,nn,s,down,phase0",
    [
        ("chirp_n16_s0_up", 16, 1, 16, 0, False, 0.0),
        ("chirp_n16_s5_up", 16, 1, 16, 5, False, 0.0),
        ("chirp_n16_s0_down", 16, 1, 16, 0, True, 0.0),
        ("chirp_n16_ovs4_s3_up", 16, 4, 64, 3, False, 0.0),
        ("chirp_n16_quarter_down", 16, 1, 4, 0, True, 0.5 / (2 * np.pi)),
        ("chirp_n256_s77_up", 256, 1, 256, 77, False, 0.125),
    ],
)
def test_golden_chirp_waveforms(key, N, ovs, nn, s, down, phase0):
    num, _ = chirp.chirp_phase_nums(s, nn, N, ovs, down)
    D = N * ovs * ovs
    iq = cplx.from_turns(num.to(torch.float32) / D + np.float32(phase0))
    np.testing.assert_allclose(iq.numpy(), golden_iq(key), atol=2e-3)


@pytest.mark.parametrize(
    "case", ["det_n16_tone5", "det_n16_noisy", "det_n256_noisy",
             "det_n256_noise", "det_n1024_noisy"],
)
def test_golden_detector_vectors(case):
    """The plain detector against the reference's compiled LoRaDetector.hpp
    on the same post-dechirp samples, at tests/test_chirp_detect.py's
    tolerances."""
    x = torch.as_tensor(golden_iq(case + "_in"))
    want_value, want_power, want_noise, want_findex = GOLDEN[case + "_out"]
    d = detect.detect(x[None])
    assert int(d.value[0]) == int(want_value)
    np.testing.assert_allclose(float(d.power[0]), want_power, atol=2e-3)
    np.testing.assert_allclose(float(d.f_index[0]), want_findex, atol=2e-3)
    if want_noise > -100:  # a pure tone's "noise" is numerical dust
        np.testing.assert_allclose(float(d.noise[0]), want_noise, atol=2e-2)
