"""The port's channel impairments (lora_tpu_torch/sim/channel.py) against
lora_tpu.sim.channel on the same numpy IQ.  AWGN cannot give jax.random's
numbers, so it is held to its seed and its statistics instead."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lora_tpu.ops import cplx as jcplx
from lora_tpu.sim import channel as jch

from lora_tpu_torch.ops import cplx
from lora_tpu_torch.sim import channel as ch

torch.set_num_threads(1)


def _iq(seed, shape=(3, 700)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _jax(x):
    return jcplx.IQ(jnp.asarray(x.real), jnp.asarray(x.imag))


@pytest.mark.parametrize(
    "name,args",
    [("rotate", (np.pi / 1.2345,)), ("cfo", (1.37, 128)), ("cfo", (-2.5, 1024)),
     ("time_offset", (300,))],
)
def test_impairments_match_jax(name, args):
    x = _iq(len(name))
    got = getattr(ch, name)(torch.as_tensor(x), *args)
    want = jcplx.to_complex(getattr(jch, name)(_jax(x), *args))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_awgn_follows_its_generator():
    x = torch.zeros((4, 50_000), dtype=torch.complex64)
    a = ch.awgn(x, 0.5, torch.Generator().manual_seed(7))
    b = ch.awgn(x, 0.5, torch.Generator().manual_seed(7))
    c = ch.awgn(x, 0.5, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    re, im = cplx.to_planar(a)
    for leg in (re, im):  # amplitude 0.5 per leg, as the JAX package
        assert abs(leg.mean()) < 0.01
        assert abs(leg.std() - 0.5) < 0.01
    assert abs(np.corrcoef(re.ravel(), im.ravel())[0, 1]) < 0.01
