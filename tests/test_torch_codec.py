"""The port's encoder and decoder against lora_tpu.encode / lora_tpu.decode:
symbols identical, and data, length, offset and status (and every other
DecodeResult field) identical on clean and corrupted symbols, with the
corruption patterns of tests/test_codec_chain.py."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lora_tpu
from lora_tpu import api as japi

from lora_tpu_torch import api as tapi

torch.set_num_threads(1)


def assert_decode_equal(jres, tres):
    for f in dataclasses.fields(tres):
        np.testing.assert_array_equal(
            getattr(tres, f.name).numpy(), np.asarray(getattr(jres, f.name)),
            err_msg=f.name,
        )


@pytest.mark.parametrize("sf", range(7, 13))
@pytest.mark.parametrize("cr", ["4/5", "4/6", "4/7", "4/8"])
def test_codec_matches_jax(sf, cr):
    rng = np.random.default_rng(100 * sf + int(cr[-1]))
    cfg = lora_tpu.LoRaConfig(sf=sf, cr=cr, crc_check=True)
    payload = rng.integers(0, 256, (3, 21)).astype(np.uint8)
    jsym = np.asarray(japi.encode(jnp.asarray(payload), cfg)).astype(np.int32)
    tsym = tapi.encode(payload, cfg).numpy()
    np.testing.assert_array_equal(tsym, jsym)
    S = jsym.shape[-1]
    N = cfg.N
    bank = np.concatenate([jsym] * 3)
    bank[3, 9] ^= 0x3F                      # one symbol past Hamming repair
    bank[4] = rng.integers(0, N, S)         # garbage frame
    bank[5, [2, 11]] ^= 0x5                 # header and payload damage
    bank[6] = (bank[6] + 1) % N             # every symbol one bin high
    bank[7, :4] = 0                         # header zeroed
    bank[8, -3:] = rng.integers(0, N, 3)    # tail (CRC) damage
    jres = japi.decode(jnp.asarray(bank), cfg)
    tres = tapi.decode(torch.as_tensor(bank), cfg)
    assert_decode_equal(jres, tres)
    assert tapi.extract_payloads(tres)[:3] == [bytes(p) for p in
                                               payload.tolist()]


@pytest.mark.parametrize(
    "kw,payload_len,keep",
    [
        # the tail past the real symbols decodes as the whitening stream
        (dict(sf=7, cr="4/4", crc=False, error_check=False), 18, 24),
        (dict(sf=9, cr="4/6", explicit_header=False, crc=True,
              crc_check=True, data_length=16), 16, None),
        (dict(sf=11, ppm=9, cr="4/7"), 33, None),
    ],
)
def test_codec_variants_match_jax(kw, payload_len, keep):
    rng = np.random.default_rng(payload_len)
    cfg = lora_tpu.LoRaConfig(**kw)
    payload = rng.integers(0, 256, (2, payload_len)).astype(np.uint8)
    jsym = np.asarray(japi.encode(jnp.asarray(payload), cfg)).astype(np.int32)
    np.testing.assert_array_equal(tapi.encode(payload, cfg).numpy(), jsym)
    if keep is not None:
        jsym = jsym[:, :keep]
    assert_decode_equal(japi.decode(jnp.asarray(jsym), cfg),
                        tapi.decode(torch.as_tensor(jsym), cfg))


def test_decode_without_interleaving_passes_gray_symbols():
    """cfg.interleaving=False returns the Gray-mapped symbols, as the JAX
    package does (it as uint16, the port as int32)."""
    cfg = lora_tpu.LoRaConfig(sf=9, ppm=7, cr="4/8", interleaving=False)
    sym = np.random.default_rng(9).integers(0, cfg.N, (3, 40)).astype(np.int32)
    want = np.asarray(japi.decode(jnp.asarray(sym), cfg))
    got = tapi.decode(torch.as_tensor(sym), cfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tapi.decode(torch.as_tensor(sym[0]), cfg),
                                  want[0])
