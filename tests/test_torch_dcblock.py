"""The port's DC blocker (lora_tpu_torch.ops.dcblock: the one-pole recurrence
blockwise, a matrix of powers of alpha inside a block and the same routine
over the blocks' carries) against lora_tpu's associative scan on the same
numpy inputs: one twin of every case of tests/test_dcblock.py.  Outputs
and carried states agree within 1e-5 of the input's largest magnitude."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lora_tpu import api as japi
from lora_tpu.config import LoRaConfig
from lora_tpu.ops import cplx as jcplx
from lora_tpu.ops import dcblock as jdc

from lora_tpu_torch import api as tapi
from lora_tpu_torch.ops import dcblock as tdc

torch.set_num_threads(1)

RTOL = 1e-5


def jdcblock(x, alpha=0.999, state=None):
    y, st = jdc.dcblock(jcplx.from_complex(x), alpha, state)
    return jcplx.to_complex(y), st


def assert_close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def test_dc_suppressed_tone_passes_matches_jax():
    n = np.arange(1 << 14)
    x = (np.exp(2j * np.pi * 0.01 * n) + (2.5 - 1.5j)).astype(np.complex64)
    y, st = tdc.dcblock(x, device="cpu")
    want, jst = jdcblock(x)
    assert_close(y.numpy(), want, 3.5)
    assert_close(st.re.numpy(), np.asarray(jst.re), 3.5)
    assert_close(st.im.numpy(), np.asarray(jst.im), 3.5)
    tail = y.numpy()[8192:]
    assert abs(tail.real.mean()) < 0.02 and abs(tail.imag.mean()) < 0.02
    assert np.sqrt((tail.real ** 2).mean()) == pytest.approx(0.707, rel=0.05)


def test_chunked_matches_oneshot_and_jax():
    rng = np.random.default_rng(3)
    T = 10_000
    x = ((rng.standard_normal(T) + 0.7)
         + 1j * (rng.standard_normal(T) - 0.2)).astype(np.complex64)
    full, _ = tdc.dcblock(x, device="cpu")
    state, parts = None, []
    for a, b in [(0, 1234), (1234, 5000), (5000, 7777), (7777, T)]:
        yc, state = tdc.dcblock(x[a:b], state=state, device="cpu")
        parts.append(yc.numpy())
    scale = np.abs(x).max()
    assert_close(np.concatenate(parts), full.numpy(), scale)
    assert_close(full.numpy(), jdcblock(x)[0], scale)


@pytest.mark.parametrize("alpha", [0.9, 0.999, 0.99995])
def test_long_stream_and_batch_match_jax(alpha):
    """Past 1024 blocks the carries recurse a second time: [2, T] streams
    of 1.2 M samples, alphas whose powers underflow within a block (0.9) or
    barely move (0.99995), against the associative scan."""
    rng = np.random.default_rng(7)
    T = 1_200_000
    x = (rng.standard_normal((2, T)) + 3.0
         + 1j * (rng.standard_normal((2, T)) - 1.0)).astype(np.complex64)
    y, st = tdc.dcblock(x, alpha=alpha, device="cpu")
    want, jst = jdcblock(x, alpha)
    scale = np.abs(x).max()
    assert y.shape == (2, T)
    assert_close(y.numpy(), want, scale)
    assert_close(st.re.numpy(), np.asarray(jst.re), scale)


def _frame_with_spike(cfg, payload, delay, spike):
    iq = tapi.modulate(tapi.encode(np.frombuffer(payload, np.uint8)[None],
                                   cfg, device="cpu"), cfg)[0].numpy()
    need = -(-(tapi.required_samples(cfg) + delay) // 4096) * 4096
    x = np.zeros(need, np.complex64)
    x[delay : delay + iq.size] = iq[: need - delay]
    return x, spike


def test_dc_spike_blocked_end_to_end_matches_jax():
    """A DC spike 30x the signal blinds the demodulator of both packages;
    through either DC blocker the frame decodes byte-exact, with the same
    decisions."""
    cfg = LoRaConfig(sf=8, ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 4)
    payload = bytes(range(16))
    x, _ = _frame_with_spike(cfg, payload, 256, 0)
    rng = np.random.default_rng(0)
    x = x + 0.05 * (rng.standard_normal(x.size)
                    + 1j * rng.standard_normal(x.size))
    xd = (x + (30.0 + 15.0j)).astype(np.complex64)[None]

    assert not bool(tapi.demodulate(xd, cfg, device="cpu").found[0])
    assert not bool(np.asarray(japi.demodulate(jnp.asarray(xd), cfg).found)[0])
    y, _ = tdc.dcblock(xd, device="cpu")
    jy, _ = jdcblock(xd)
    assert_close(y.numpy(), jy, 34.0)
    dem = tapi.demodulate(y, cfg)
    jdem = japi.demodulate(jnp.asarray(jy), cfg)
    for f in ("found", "symbols", "t_sync", "freq_error"):
        np.testing.assert_array_equal(getattr(dem, f).numpy(),
                                      np.asarray(getattr(jdem, f)))
    assert tapi.extract_payloads(tapi.decode(dem.symbols, cfg)) == [payload]


def test_replay_dc_block_flag_matches_jax(tmp_path):
    """replay_file(dc_block=True) recovers a capture whose tuner DC spike
    dwarfs the burst, chunked so that the blocker's state crosses a seam
    inside the frame; without it nothing decodes, in both packages."""
    from lora_tpu.hw.capture import replay_file as jreplay
    from lora_tpu_torch.hw.capture import replay_file as treplay
    from lora_tpu_torch.models.decoder import OK

    cfg = LoRaConfig(sf=8, cr="4/6", ampl=0.5)
    cfg = cfg.replace(mtu=cfg.num_symbols(6) + 2)
    iq = tapi.modulate(tapi.encode(np.frombuffer(b"dcspke", np.uint8)[None],
                                   cfg, device="cpu"), cfg)[0].numpy()
    x = np.concatenate([np.zeros(777, np.complex64), iq,
                        np.zeros(9000, np.complex64)]) + (15.0 - 7.5j)
    inter = np.empty(x.size * 2, np.float32)
    inter[0::2], inter[1::2] = x.real, x.imag
    f = tmp_path / "cap.cf32"
    f.write_bytes(inter.tobytes())
    base = treplay(str(f), "cf32", cfg, chunk=8192, device="cpu")
    assert not any(fr.status == OK for fr in base)
    assert not any(fr.status == OK for fr in jreplay(str(f), "cf32", cfg,
                                                     chunk=8192))
    frames = treplay(str(f), "cf32", cfg, chunk=8192, dc_block=True,
                     device="cpu")
    jframes = jreplay(str(f), "cf32", cfg, chunk=8192, dc_block=True)
    assert len(frames) == 1 and frames[0].payload == b"dcspke"
    assert [(fr.t_start, fr.payload, fr.status) for fr in frames] == [
        (fr.t_start, fr.payload, fr.status) for fr in jframes]
