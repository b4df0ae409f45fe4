"""ops/shift.py against lora_tpu.ops.shift on the same numpy rows: the row
gather and the sub-window shift (kernel E's contract and plain version),
leads [B] and [B, K], r at 0, 1, N - 1 and random; the JAX function both on
its jnp route and through its Pallas kernel in interpret mode.  A copy:
bit-equal."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lora_tpu.ops import cplx as jcplx
from lora_tpu.ops import shift as jshift

from lora_tpu_torch.ops import shift as tshift

torch.set_num_threads(1)


def _rows(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _jiq(a):
    return jcplx.IQ(jnp.asarray(a.real.copy()), jnp.asarray(a.imag.copy()))


def _jnp_complex(iq):
    return np.asarray(iq.re) + 1j * np.asarray(iq.im)


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("lead,N,R,mtu", [
    ((5,), 128, 9, 8), ((3, 2), 128, 18, 17), ((4,), 256, 30, 25),
    ((2, 3), 64, 6, 3),
])
def test_shift_windows_matches_jax(lead, N, R, mtu, interpret):
    rng = np.random.default_rng(N + R)
    g = _rows(rng, (*lead, R, N))
    r = rng.integers(0, N, lead).astype(np.int32)
    r.reshape(-1)[:3] = (0, 1, N - 1)
    want = _jnp_complex(jshift.shift_windows(_jiq(g), jnp.asarray(r), mtu,
                                             interpret=interpret))
    for fn in (tshift.shift_windows, tshift.shift_windows_plain):
        got = fn(torch.as_tensor(g), torch.as_tensor(r), mtu)
        assert got.shape == (*lead, mtu, N) and got.dtype == torch.complex64
        np.testing.assert_array_equal(got.numpy(), want)
    # the definition: window w = g[w, r:] ++ g[w + 1, :r]
    b = (0,) * len(lead)
    rb = int(r[b])
    np.testing.assert_array_equal(
        got[b][mtu - 1].numpy(),
        np.concatenate([g[b][mtu - 1, rb:], g[b][mtu, :rb]]))


@pytest.mark.parametrize("kshape", [(), (3,)])
def test_gather_rows_matches_jax(kshape):
    rng = np.random.default_rng(7)
    B, N, W, n_rows = 4, 64, 20, 6
    x = _rows(rng, (B, W * N + 17))  # a tail shorter than a row is ignored
    q = rng.integers(-3, W + 3, (B, *kshape)).astype(np.int32)  # clamped
    want = _jnp_complex(jshift.gather_rows(_jiq(x), jnp.asarray(q), n_rows, N))
    got = tshift.gather_rows(torch.as_tensor(x), torch.as_tensor(q), n_rows, N)
    assert got.shape == (B, *kshape, n_rows, N)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_then_shift_is_the_sample_slice():
    """Both steps together cut x[b, t : t + mtu*N] for any t whose rows fit."""
    rng = np.random.default_rng(3)
    B, K, N, mtu, W = 3, 2, 64, 5, 12
    x = _rows(rng, (B, W * N))
    t = rng.integers(0, (W - mtu - 1) * N, (B, K))
    xt, tt = torch.as_tensor(x), torch.as_tensor(t)
    got = tshift.shift_windows(
        tshift.gather_rows(xt, tt // N, mtu + 1, N), tt % N, mtu).numpy()
    for b in range(B):
        for k in range(K):
            np.testing.assert_array_equal(
                got[b, k].reshape(-1), x[b, t[b, k] : t[b, k] + mtu * N])


@pytest.mark.parametrize("fn", [tshift.shift_windows,
                                tshift.shift_windows_plain])
def test_shift_windows_refusals(fn):
    g = torch.zeros((2, 5, 64), dtype=torch.complex64)
    r = torch.zeros(2, dtype=torch.int32)
    assert fn(g, r, 4).shape == (2, 4, 64)
    with pytest.raises(ValueError, match="rows < mtu"):
        fn(g, r, 5)
    with pytest.raises(ValueError, match=r"expected \[0, 64\)"):
        fn(g, torch.tensor([0, 64], dtype=torch.int32), 4)
    with pytest.raises(ValueError, match=r"expected \[0, 64\)"):
        fn(g, torch.tensor([-1, 3], dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="r of shape"):
        fn(g, torch.zeros(3, dtype=torch.int32), 4)
    with pytest.raises(TypeError, match="integer"):
        fn(g, torch.zeros(2), 4)
    with pytest.raises(ValueError, match="expected"):
        fn(g[0, 0], r, 4)
