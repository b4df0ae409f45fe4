"""Where the port's sensitivity counts differ from the committed rows of
docs/sensitivity_vs_reference.json, the difference is lora_tpu's own.

lora_tpu measured those rows on a TPU.  At four of its 60 points the
port (on the card and on the CPU) recovers one frame more or fewer
(chip_smoke.py step 9a).  On the same bank, rebuilt draw for draw from
lora_tpu's clean frames, lora_tpu on the CPU gives the port's counts, and
the two packages decide every frame alike: the committed counts there
carry the TPU run's float32 rounding at a near tie."""

import numpy as np
import pytest
import jax.numpy as jnp

import lora_tpu
from lora_tpu import api as japi
from lora_tpu.ops import cplx as jcplx

from lora_tpu_torch.tools import bench_sensitivity as bs

# (sf, cr, noise, n) -> the port's (hard, soft) on the card, step 9a
POINTS = {(7, "4/5", 2.3, 256): (31, 134), (8, "4/7", 3.4, 32): (0, 19),
          (8, "4/8", 3.0, 32): (6, 29), (12, "4/8", 9.6, 32): (22, 32)}


@pytest.mark.parametrize("point", list(POINTS), ids=lambda p: "-".join(
    str(v) for v in p))
def test_committed_delta_is_lora_tpus_own(point):
    sf, cr, noise, n = point
    old = bs.committed_row(bs.committed_rows(), sf, cr, noise, 0, n)
    assert (old["recovered_ours"], old["recovered_soft"]) != POINTS[point]
    cfg = bs.point_cfg(sf, cr)
    jcfg = lora_tpu.LoRaConfig(sf=sf, cr=cr, ampl=1.0)
    jcfg = jcfg.replace(mtu=jcfg.num_symbols(16) + 4)
    rng, pay, delays = bs.draw(cfg, noise, n)
    clean = japi.modulate(japi.encode(jnp.asarray(pay), jcfg), jcfg)
    re, im = bs.noisy(rng, np.asarray(clean.re), np.asarray(clean.im),
                      delays, lora_tpu.required_samples(jcfg), noise)
    dem = japi.demodulate(jcplx.IQ(jnp.asarray(re), jnp.asarray(im)), jcfg,
                          spectra=True)
    found = np.asarray(dem.found)
    hard = bs.recovered(found, japi.extract_payloads(
        japi.decode(dem.symbols.astype(jnp.int32), jcfg)), pay)
    soft = bs.recovered(found, japi.extract_payloads(
        japi.decode_soft(dem.fft_mag2, jcfg)), pay)
    assert (hard.sum(), soft.sum()) == POINTS[point]
    _, pf = bs.point(cfg, noise, n, soft=True, fused="off", device="cpu",
                     bank=bs.Bank(pay, delays, re, im))
    np.testing.assert_array_equal(pf["found"], found)
    np.testing.assert_array_equal(pf["symbols"], np.asarray(dem.symbols))
    np.testing.assert_array_equal(pf["hard"], hard)
    np.testing.assert_array_equal(pf["soft"], soft)
