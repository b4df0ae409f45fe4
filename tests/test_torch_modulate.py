"""The port's chirp phase and modulator against lora_tpu: the integer phase
numerators exactly, the IQ within 1e-5 (float32 cos/sin of the same angle
in two libraries)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import lora_tpu
from lora_tpu import api as japi
from lora_tpu.models import modulator as jmod
from lora_tpu.ops import chirp as jchirp
from lora_tpu.ops import cplx as jcplx

from lora_tpu_torch import api as tapi
from lora_tpu_torch.models import modulator as tmod
from lora_tpu_torch.ops import chirp, cplx

torch.set_num_threads(1)


@pytest.mark.parametrize("N,ovs", [(64, 1), (1024, 1), (4096, 1), (16, 4),
                                   (256, 8)])
def test_phase_numerators_exact(N, ovs):
    rng = np.random.default_rng(N + ovs)
    syms = np.concatenate([[0, 1, N - 1], rng.integers(0, N, 5)])
    for down in (False, True):
        for n_samples in (N * ovs, N * ovs // 4):
            mine, carry = chirp.chirp_phase_nums(syms, n_samples, N, ovs, down,
                                                 device="cpu")
            want, wcarry = jax.vmap(lambda s: jchirp.chirp_phase_nums(
                s, n_samples, N, ovs, down))(jnp.asarray(syms))
            np.testing.assert_array_equal(mine.numpy(), np.asarray(want))
            np.testing.assert_array_equal(carry.numpy(), np.asarray(wcarry))


@pytest.mark.parametrize("sf,cr,pre,sync", [(7, "4/8", 10, 0x12),
                                            (8, "4/5", 8, 0x34),
                                            (10, "4/8", 10, 0x12),
                                            (12, "4/7", 6, 0x3C)])
def test_modulate_matches_jax(sf, cr, pre, sync):
    cfg = lora_tpu.LoRaConfig(sf=sf, cr=cr, ampl=0.7, preamble_symbols=pre,
                              sync=sync)
    head, carry = tmod.preamble_nums(cfg, "cpu")
    jhead, jcarry = jmod.preamble_nums(cfg)
    np.testing.assert_array_equal(head.numpy(), np.asarray(jhead))
    assert carry == int(jcarry)
    rng = np.random.default_rng(sf)
    payload = rng.integers(0, 256, (3, 12)).astype(np.uint8)
    jsym = japi.encode(jnp.asarray(payload), cfg)
    jiq = jcplx.to_complex(japi.modulate(jsym, cfg))
    tiq = tapi.modulate(tapi.encode(payload, cfg, device="cpu"), cfg)
    assert tiq.dtype == torch.complex64
    assert tiq.shape == jiq.shape == (3, cfg.frame_samples(jsym.shape[-1]))
    np.testing.assert_allclose(tiq.numpy(), jiq, rtol=0, atol=1e-5)


def test_iq_converts_between_packages():
    """A JAX IQ pair becomes a complex64 tensor without jax in the port,
    and to_planar gives the planar numpy back bit for bit."""
    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/8", ampl=0.5)
    jiq = japi.modulate(japi.encode(jnp.arange(6, dtype=jnp.uint8)[None], cfg),
                        cfg)
    re, im = np.asarray(jiq.re), np.asarray(jiq.im)
    t = cplx.as_iq(jiq, "cpu")
    assert t.dtype == torch.complex64 and t.shape == re.shape
    for got in (cplx.to_planar(t), cplx.to_planar(cplx.from_planar(re, im, "cpu"))):
        np.testing.assert_array_equal(got[0], re)
        np.testing.assert_array_equal(got[1], im)
    np.testing.assert_array_equal(cplx.as_iq(re + 1j * im, "cpu").numpy(),
                                  t.numpy())
    real = cplx.as_iq(re, "cpu")
    np.testing.assert_array_equal(real.real.numpy(), re)
    assert not bool(real.imag.any())


def _record_default_device(monkeypatch):
    """Stand a CPU in for the card and record what resolve_device is asked:
    None is the request for the card."""
    asked = []

    def resolve(device=None):
        asked.append(device)
        return torch.device("cpu")

    assert cplx.resolve_device(None).type == "cuda"
    monkeypatch.setattr(cplx, "resolve_device", resolve)
    return asked


def test_chirp_phase_nums_follows_the_device_rule(monkeypatch):
    """Host symbols go to the card unless a device is named; a tensor is
    used where it lies."""
    asked = _record_default_device(monkeypatch)
    num, carry = chirp.chirp_phase_nums(np.arange(3), 16, 16)
    assert asked == [None] and num.shape == (3, 16)
    chirp.chirp_phase_nums(5, 16, 16, device="cpu")
    assert asked == [None, "cpu"]
    on_cpu, _ = chirp.chirp_phase_nums(torch.arange(3), 16, 16)
    assert asked == [None, "cpu"] and on_cpu.device.type == "cpu"
    assert torch.equal(on_cpu, num)


def test_dechirp_table_follows_the_device_rule(monkeypatch):
    """The dechirp table goes to the card unless a device is named."""
    asked = _record_default_device(monkeypatch)
    chirp.dechirp_table.cache_clear()
    try:
        t = chirp.dechirp_table(64)
        assert asked == [None, None]  # the two planes
        named = chirp.dechirp_table(64, False, "cpu")
        assert asked == [None, None, "cpu", "cpu"]
        assert torch.equal(t, named) and t.dtype == torch.complex64
    finally:
        chirp.dechirp_table.cache_clear()
