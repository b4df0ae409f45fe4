"""The port's streaming runtime (lora_tpu_torch.runtime) against lora_tpu's on
the same numpy streams: one twin of every case of tests/test_runtime.py.
Frames must match field by field (channel, t_start, data_start, symbols,
freq_error, payload, status) and the read pointers after every device
step; the port runs on the CPU here (device="cpu"), its ring a complex64
tensor.  Plus: checkpoints load across the packages, the soft stream, and
the entry points' device default."""

import io
import threading
import time

import numpy as np
import pytest
import torch

from lora_tpu.config import LoRaConfig
from lora_tpu.runtime import StreamDemodulator as JStream
from lora_tpu.runtime import decode_frames as jdecode_frames
from lora_tpu.runtime import iqio as jiqio

from lora_tpu_torch import api as tapi
from lora_tpu_torch.runtime import StreamDemodulator as TStream
from lora_tpu_torch.runtime import decode_frames as tdecode_frames
from lora_tpu_torch.runtime import iqio as tiqio

torch.set_num_threads(1)


def recording(cls):
    """The stream class with the read pointers logged after every step."""

    class Recorded(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.log = []

        def _step_end(self, dem):
            out = super()._step_end(dem)
            self.log.append(self.offsets.copy())
            return out

    return Recorded


def both(cfg, channels, **kw):
    """(lora_tpu's stream, the port's on the CPU), both recording."""
    return (recording(JStream)(cfg, channels=channels, **kw),
            recording(TStream)(cfg, channels=channels, device="cpu", **kw))


def frame_key(f):
    return (f.channel, f.t_start, f.data_start, tuple(int(s) for s in f.symbols),
            f.freq_error, f.payload, f.status)


def assert_same_run(jsd, tsd, jframes, tframes):
    """Equal frames, and equal read pointers after every step."""
    assert [frame_key(f) for f in tframes] == [frame_key(f) for f in jframes]
    assert len(tsd.log) == len(jsd.log) > 0
    for a, b in zip(tsd.log, jsd.log):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsd.offsets, jsd.offsets)


def frame_iq(cfg, payload):
    """One frame of `payload` as complex64 numpy [L] (the port's modulator,
    handed to both packages)."""
    iq = tapi.modulate(tapi.encode(np.asarray(payload)[None], cfg,
                                   device="cpu"), cfg)
    return iq[0].numpy()


def make_stream(cfg, payloads, gaps, rng, noise=0.0):
    """One channel: frames at increasing offsets separated by `gaps`."""
    chunks, pos, starts = [], 0, []
    for p, g in zip(payloads, gaps):
        chunks.append(np.zeros(g, np.complex64))
        pos += g
        starts.append(pos)
        x = frame_iq(cfg, p)
        chunks.append(x)
        pos += x.size
    chunks.append(np.zeros(4 * cfg.N, np.complex64))
    x = np.concatenate(chunks)
    if noise:
        x = x + noise * (rng.standard_normal(x.size)
                         + 1j * rng.standard_normal(x.size)).astype(np.complex64)
    return x.astype(np.complex64), starts


def feed_run(sd, x, step, decode, **kw):
    frames = []
    for i in range(0, x.shape[-1], step):
        sd.feed(x[..., i : i + step])
        frames.extend(sd.run())
    frames.extend(sd.flush())
    return decode(frames, sd.cfg, **kw)


def test_stream_recovers_multiple_frames_matches_jax(rng):
    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(8) + 2)
    payloads = [rng.integers(0, 256, 8).astype(np.uint8) for _ in range(4)]
    x, starts = make_stream(cfg, payloads, [700, 1500, 333, 2048], rng,
                            noise=0.05)
    jsd, tsd = both(cfg, 1)
    jf = feed_run(jsd, x[None], 5000, jdecode_frames)
    tf = feed_run(tsd, x[None], 5000, tdecode_frames, device="cpu")
    assert_same_run(jsd, tsd, jf, tf)
    assert [abs(f.t_start - s) <= 1 for f, s in zip(tf, starts)] == [True] * 4
    assert [f.payload for f in tf] == [bytes(p.tolist()) for p in payloads]


def test_stream_channels_diverge_matches_jax(rng):
    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
    p0 = rng.integers(0, 256, 4).astype(np.uint8)
    p1 = rng.integers(0, 256, 4).astype(np.uint8)
    x0, _ = make_stream(cfg, [p0, p0], [100, 4000], rng)
    x1, _ = make_stream(cfg, [p1], [9000], rng)
    bank = np.zeros((2, max(x0.size, x1.size)), np.complex64)
    bank[0, : x0.size] = x0
    bank[1, : x1.size] = x1
    jsd, tsd = both(cfg, 2)
    jsd.feed(bank)
    tsd.feed(bank)
    jf = jdecode_frames(list(jsd.run()) + jsd.flush(), cfg)
    tf = tdecode_frames(list(tsd.run()) + tsd.flush(), cfg, device="cpu")
    assert_same_run(jsd, tsd, jf, tf)
    assert [f.channel for f in tf].count(0) == 2
    assert [f.channel for f in tf].count(1) == 1
    assert all(f.status == 0 for f in tf)


@pytest.mark.parametrize("fmt,dtype", [("cs8", np.int8), ("cu8", np.uint8),
                                       ("cs16", np.int16),
                                       ("cf32", np.float32)])
def test_iq_convert_formats_match_jax(fmt, dtype):
    """The port's copy of the native converters (built under build/, not in
    the package) gives the JAX package's values on the same bytes, odd
    trailing scalars included; interleave_cf32 round-trips."""
    rng = np.random.default_rng(5)
    n = 65
    if dtype == np.float32:
        raw = rng.standard_normal(2 * n + 1).astype(dtype)
    else:
        info = np.iinfo(dtype)
        raw = rng.integers(info.min, info.max, 2 * n + 1).astype(dtype)
    assert tiqio.get_lib() is not None
    got = tiqio.convert(raw.tobytes(), fmt)
    want = jiqio.convert(raw.tobytes(), fmt)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (n,)
        np.testing.assert_array_equal(g, w)
    re = np.arange(8, dtype=np.float32)
    inter = tiqio.interleave_cf32(re, -re)
    np.testing.assert_array_equal(inter, jiqio.interleave_cf32(re, -re))
    r2, i2 = tiqio.convert(inter.tobytes(), "cf32")
    np.testing.assert_array_equal(r2, re)
    np.testing.assert_array_equal(i2, -re)


def test_iqio_library_builds_under_build_dir():
    """The native library goes to build/lora_tpu_torch/ under a name hashed
    from its source, never into the package."""
    from lora_tpu_torch.ops import _cuda

    assert tiqio.get_lib() is not None
    so = tiqio.library_path()
    assert so.exists() and so.parent == _cuda.BUILD_DIR
    assert so.name.startswith("libiqio_")
    pkg = tiqio.SOURCE.parent
    assert not list(pkg.glob("*.so"))


def test_iq_ring_wraparound_matches_jax():
    for mod in (tiqio, jiqio):
        ring = mod.IqRing(100)
        assert ring.write(np.arange(60, dtype=np.float32),
                          np.zeros(60, np.float32)) == 60
        re, _ = ring.read(50)
        np.testing.assert_array_equal(re, np.arange(50, dtype=np.float32))
        wrote = ring.write(np.arange(60, 140, dtype=np.float32),
                           np.zeros(80, np.float32))
        assert wrote == 80 and ring.available == 90
        re, _ = ring.read(90)
        np.testing.assert_array_equal(re, np.arange(50, 140, dtype=np.float32))
        ring2 = mod.IqRing(10)
        w = ring2.write(np.ones(25, np.float32), np.ones(25, np.float32))
        assert w == 10 and ring2.dropped == 15


def test_stream_multi_frame_per_step_matches_jax(rng):
    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
    payloads = [rng.integers(0, 256, 4).astype(np.uint8) for _ in range(5)]
    x, starts = make_stream(cfg, payloads, [200, 150, 400, 120, 300], rng,
                            noise=0.02)
    jsd, tsd = both(cfg, 1, max_frames=3)
    runs = []
    for sd, decode, kw in ((jsd, jdecode_frames, {}),
                           (tsd, tdecode_frames, {"device": "cpu"})):
        sd.feed(x[None])
        frames = []
        while sd.ready():
            frames.extend(sd.step())
        steps = len(sd.log)
        frames.extend(sd.flush())
        runs.append(decode(frames, cfg, **kw))
    assert_same_run(jsd, tsd, *runs)
    tf = runs[1]
    assert [f.payload for f in tf] == [bytes(p.tolist()) for p in payloads]
    assert all(abs(f.t_start - s) <= 1 for f, s in zip(tf, starts))
    assert steps <= 4  # dense frames: several a step


def test_stream_soak_matches_jax(rng):
    """Many frames, random payload sizes, random gaps (back-to-back
    included) and noise: every frame recovered once and byte-exact, the
    same run in both packages."""
    cfg = LoRaConfig(sf=7, cr="4/7", ampl=1.0)
    max_len = 12
    cfg = cfg.replace(mtu=cfg.num_symbols(max_len) + 2)
    n_frames = 18
    payloads = [rng.integers(0, 256, int(rng.integers(1, max_len + 1))).astype(
        np.uint8) for _ in range(n_frames)]
    # a gap after frame i must exceed its mtu overshoot
    overshoot = [(cfg.mtu - cfg.num_symbols(len(p))) * cfg.N + cfg.N
                 for p in payloads]
    base = rng.integers(0, 4000, n_frames)
    gaps = [int(b) + (overshoot[i - 1] if i else 0) for i, b in enumerate(base)]
    x, starts = make_stream(cfg, payloads, gaps, rng, noise=0.05)
    jsd, tsd = both(cfg, 1, max_frames=2)
    jf = feed_run(jsd, x[None], 40000, jdecode_frames)
    tf = feed_run(tsd, x[None], 40000, tdecode_frames, device="cpu")
    assert_same_run(jsd, tsd, jf, tf)
    assert len(tf) == n_frames
    for f, p, s in zip(tf, payloads, starts):
        assert abs(f.t_start - s) <= 1
        assert f.status == 0 and f.payload == bytes(p.tolist())


def test_stream_exact_advance_back_to_back_matches_jax(rng):
    cfg = LoRaConfig(sf=7, cr="4/7", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(12) + 8)
    payloads = [rng.integers(0, 256, 4).astype(np.uint8) for _ in range(6)]
    x, starts = make_stream(cfg, payloads, [40, 0, 3, 0, 17, 1], rng,
                            noise=0.02)
    jsd, tsd = both(cfg, 1, max_frames=2, exact_advance=True)
    jsd.feed(x[None])
    tsd.feed(x[None])
    jf = list(jsd.run()) + jsd.flush()
    tf = list(tsd.run()) + tsd.flush()
    assert_same_run(jsd, tsd, jf, tf)
    assert len(tf) == 6
    for f, p, s in zip(tf, payloads, starts):
        assert abs(f.t_start - s) <= 1
        assert f.status == 0 and f.payload == bytes(p.tolist())


def test_ring_matches_flat_buffer_and_jax(rng):
    """The port's device ring (mirrored tail, one gather) against a flat
    buffer and lora_tpu's host _Ring, across growth and many wraparounds."""
    from lora_tpu.runtime.stream import _Ring as JRing
    from lora_tpu_torch.runtime.stream import _Ring as TRing

    B, W_max = 3, 37
    ring = TRing(B, 64, W_max, "cpu")  # tiny: growth and wraps
    jring = JRing(B, 64)
    flat = np.zeros((B, 0), np.complex64)
    base = 0
    for _ in range(40):
        n = int(rng.integers(1, 200))
        x = (rng.standard_normal((B, n))
             + 1j * rng.standard_normal((B, n))).astype(np.complex64)
        flat = np.concatenate([flat, x], axis=1)
        ring.append(torch.as_tensor(x))
        jring.append(x.real.copy(), x.imag.copy())
        base = max(base, ring.end - int(rng.integers(1, 300)))
        ring.trim(base)
        jring.trim(base)
        assert (ring.base, ring.end) == (jring.base, jring.end)
        W = min(W_max, ring.end - ring.base)
        if W > 0:
            offs = ring.base + rng.integers(0, ring.end - ring.base - W + 1, B)
            got = ring.gather(offs, W).numpy()
            for b in range(B):
                np.testing.assert_array_equal(got[b],
                                              flat[b, offs[b] : offs[b] + W])
            jre, jim = jring.gather(offs, W)
            np.testing.assert_array_equal(got.real, jre)
            np.testing.assert_array_equal(got.imag, jim)
            v = ring.view(ring.base, ring.end - ring.base).numpy()
            np.testing.assert_array_equal(v, flat[:, ring.base : ring.end])


def test_pump_matches_run_and_jax(rng):
    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(6) + 2)
    payloads = [rng.integers(0, 256, 6).astype(np.uint8) for _ in range(3)]
    x, starts = make_stream(cfg, payloads, [500, 2200, 900], rng, noise=0.05)
    blocks = lambda: (x[None, i : i + 4000] for i in range(0, x.size, 4000))
    jsd, tsd = both(cfg, 1)
    jf = jdecode_frames(list(jsd.pump(blocks())) + jsd.flush(), cfg)
    tf = tdecode_frames(list(tsd.pump(blocks())) + tsd.flush(), cfg,
                        device="cpu")
    assert_same_run(jsd, tsd, jf, tf)
    run_sd = TStream(cfg, channels=1, device="cpu")
    rf = feed_run(run_sd, x[None], 4000, tdecode_frames, device="cpu")
    assert [frame_key(f) for f in rf] == [frame_key(f) for f in tf]
    assert [f.t_start for f in tf] == pytest.approx(starts, abs=1)
    assert all(f.status == 0 for f in tf) and len(tf) == 3


@pytest.mark.parametrize("cfo,max_frames", [("frame", 1), ("channel", 1),
                                            ("frame", 2)])
def test_stream_cfo_per_frame_losses_match_jax(cfo, max_frames):
    """The traffic of chip_smoke.py step 6a at SF8 on 32 channels: three
    32-byte frames a channel at gaps of [0, 6N) plus the mtu overshoot,
    AWGN 0.1, and a CFO of u bins (|u| < 0.4) either for each frame or one
    a channel (one transmitter).  The single-frame search takes the
    earliest agreeing pair within 6 dB of the strongest, so with a CFO of
    its own a frame whose preamble peak the fractional CFO splits may lose
    to the next frame's preamble at the window's end.  Both packages run
    the same steps and lose the same frames; with one CFO a channel, or
    with max_frames=2 (no 6 dB rule), none is lost.  Run with -s to see
    the counts."""
    g = np.random.default_rng(7)
    cfg = LoRaConfig(sf=8, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(32) + 4)
    B, F, N = 32, 3, cfg.N
    pay = g.integers(0, 256, (B * F, 32)).astype(np.uint8)
    frames = tapi.modulate(tapi.encode(pay, cfg, device="cpu"),
                           cfg).numpy().reshape(B, F, -1)
    Lf = frames.shape[-1]
    gaps = g.integers(0, 6 * N, (B, F))
    gaps[:, 1:] += (cfg.mtu - cfg.num_symbols(32)) * N + N
    starts = np.cumsum(gaps, 1) + np.arange(F) * Lf
    L = int(starts[:, -1].max()) + Lf + 2 * N
    u = g.uniform(-0.4, 0.4, (B, F) if cfo == "frame" else (B, 1))
    u = np.broadcast_to(u, (B, F))
    phase = g.uniform(0, 2 * np.pi, (B, F))
    x = (0.1 * (g.standard_normal((B, L)) + 1j * g.standard_normal((B, L)))
         ).astype(np.complex64)
    n = np.arange(Lf)
    for b in range(B):
        for j in range(F):
            x[b, starts[b, j] : starts[b, j] + Lf] += frames[b, j] * np.exp(
                1j * (u[b, j] * 2 * np.pi / N * n + phase[b, j])
            ).astype(np.complex64)
    jsd, tsd = both(cfg, B, max_frames=max_frames)
    jf = feed_run(jsd, x, 4096, jdecode_frames)
    tf = feed_run(tsd, x, 4096, tdecode_frames, device="cpu")
    assert_same_run(jsd, tsd, jf, tf)

    def lost(got):
        return [(b, j) for b in range(B) for j in range(F)
                if [f.payload for f in got if f.channel == b and f.status == 0
                    and abs(f.t_start - starts[b, j]) <= 1]
                != [bytes(pay[b * F + j])]]

    print(f"\nCFO a {cfo}, max_frames={max_frames}: {len(lost(tf))} of "
          f"{B * F} frames lost by the port, {len(lost(jf))} by lora_tpu, "
          f"the same frames: {lost(tf) == lost(jf)}")
    assert lost(tf) == lost(jf)
    assert bool(lost(tf)) == (cfo == "frame" and max_frames == 1)


def test_slab_bank_matches_jax(rng):
    """demodulate_bank over 3 slabs (a zero-padded tail) equals one whole
    call of either package; a planar host bank of 11 channels."""
    from lora_tpu.models.demodulator import demodulate as jdemodulate
    from lora_tpu.ops import cplx as jcplx
    from lora_tpu.runtime import demodulate_bank as jbank
    from lora_tpu_torch.runtime import demodulate_bank as tbank

    cfg = LoRaConfig(sf=7, cr="4/7", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(5) + 2)
    B, T = 11, tapi.required_samples(cfg)
    payload = rng.integers(0, 256, (B, 5)).astype(np.uint8)
    iq = tapi.modulate(tapi.encode(payload, cfg, device="cpu"), cfg).numpy()
    re = np.zeros((B, T), np.float32)
    im = np.zeros((B, T), np.float32)
    re[:, : iq.shape[-1]] = iq.real[:, :T]
    im[:, : iq.shape[-1]] = iq.imag[:, :T]
    re += 0.03 * rng.standard_normal((B, T)).astype(np.float32)
    im += 0.03 * rng.standard_normal((B, T)).astype(np.float32)
    re[7] *= 0.001
    im[7] *= 0.001
    whole = jdemodulate(jcplx.IQ(re, im), cfg)
    jslab = jbank(re, im, cfg, slab=4)
    slabbed = tbank(re, im, cfg, slab=4, device="cpu")
    one = tapi.demodulate(re + 1j * im, cfg, device="cpu")
    for name in ("found", "symbols", "count", "t_sync", "consumed",
                 "freq_error", "payload_complete"):
        got = getattr(slabbed, name)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            getattr(whole, name)), err_msg=name)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            getattr(jslab, name)), err_msg=name)
        assert torch.equal(got, getattr(one, name)), name
    assert int(slabbed.found.sum()) >= B - 1


def test_live_tap_view_matches_jax():
    """LiveTapView on the observer hook paints the same dashboard over the
    same stream in both packages, once a step."""
    from lora_tpu.utils.live import LiveTapView as JView
    from lora_tpu_torch.utils.live import LiveTapView as TView

    cfg = LoRaConfig(sf=7, cr="4/7", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(8) + 4)
    frame = frame_iq(cfg, np.frombuffer(b"liveview", np.uint8))
    T = 2 * tapi.required_samples(cfg)
    x = np.zeros((2, T), np.complex64)
    x[0, 100 : 100 + frame.size] = frame
    g = np.random.default_rng(4)
    x[1] = 0.05 * (g.standard_normal(T) + 1j * g.standard_normal(T))
    texts = []
    for Stream, View, decode, kw in (
        (JStream, JView, jdecode_frames, {}),
        (TStream, TView, tdecode_frames, {"device": "cpu"}),
    ):
        out = io.StringIO()
        view = View(channels=2, out=out)
        sd = Stream(cfg, channels=2, observer=view, **kw)
        sd.feed(x)
        frames = decode(list(sd.run()) + sd.flush(), cfg, **kw)
        assert [f.payload for f in frames if f.channel == 0] == [b"liveview"]
        assert view.steps >= 1 and view.total_frames == len(frames)
        assert out.getvalue().count("live taps") == view.steps
        texts.append((out.getvalue(), view.render(sd.offsets)))
    assert texts[1] == texts[0]
    assert "frame@100" in texts[1][1] and len(texts[1][1].splitlines()) == 4


def test_pump_consumer_abandons_early_port(rng):
    """An abandoned pump() generator releases its ingest thread."""
    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
    B = 2
    p = rng.integers(0, 256, (B, 4)).astype(np.uint8)
    wire = tapi.modulate(tapi.encode(p, cfg, device="cpu"), cfg).numpy()
    T = wire.shape[-1] + 60000
    bank = np.zeros((B, T), np.complex64)
    bank[:, 500 : 500 + wire.shape[-1]] = wire

    def blocks():
        for i in range(0, T, 4096):
            yield bank[:, i : i + 4096]

    before = threading.active_count()
    sd = TStream(cfg, channels=B, device="cpu")
    for _f in sd.pump(blocks()):
        break
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= before, "pump worker leaked"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_across_packages(rng, writer):
    """save_state mid-stream in one package, load_state in the other: the
    rest of the stream gives the frames and pointers of an uninterrupted
    run (same .npz keys: offsets, base, planar re/im)."""
    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(6) + 2)
    payloads = [rng.integers(0, 256, 6).astype(np.uint8) for _ in range(3)]
    x0, _ = make_stream(cfg, payloads, [300, 1800, 700], rng, noise=0.05)
    x1, _ = make_stream(cfg, payloads, [1500, 900, 400], rng, noise=0.05)
    bank = np.zeros((2, max(x0.size, x1.size)), np.complex64)
    bank[0, : x0.size] = x0
    bank[1, : x1.size] = x1
    cut = 9000

    ref = TStream(cfg, channels=2, device="cpu")
    want = feed_run(ref, bank, 3000, tdecode_frames, device="cpu")

    first = (JStream(cfg, channels=2) if writer == "jax"
             else TStream(cfg, channels=2, device="cpu"))
    frames = []
    for i in range(0, cut, 3000):
        first.feed(bank[:, i : i + 3000])
        frames.extend(first.run())
    buf = io.BytesIO()
    first.save_state(buf)
    buf.seek(0)
    z = np.load(buf)
    assert sorted(z.files) == ["base", "im", "offsets", "re"]
    assert z["re"].dtype == np.float32 and z["offsets"].dtype == np.int64
    buf.seek(0)
    second = (TStream(cfg, channels=2, device="cpu") if writer == "jax"
              else JStream(cfg, channels=2))
    second.load_state(buf)
    for i in range(cut, bank.shape[1], 3000):
        second.feed(bank[:, i : i + 3000])
        frames.extend(second.run())
    frames.extend(second.flush())
    got = tdecode_frames(frames, cfg, device="cpu")
    assert [frame_key(f) for f in got] == [frame_key(f) for f in want]
    np.testing.assert_array_equal(second.offsets, ref.offsets)
    assert sum(f.status == 0 for f in got) == 6


def test_stream_soft_matches_jax(rng):
    """soft=True: ML-corrected symbols, confidence and the guarded statuses
    of decode_frames equal lora_tpu's."""
    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(8) + 2)
    payloads = [rng.integers(0, 256, 8).astype(np.uint8) for _ in range(2)]
    x, _ = make_stream(cfg, payloads, [900, 1300], rng, noise=0.3)
    jsd, tsd = both(cfg, 1, soft=True)
    jf = feed_run(jsd, x[None], 6000, jdecode_frames)
    tf = feed_run(tsd, x[None], 6000, tdecode_frames, device="cpu")
    assert_same_run(jsd, tsd, jf, tf)
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a.hard_symbols, b.hard_symbols)
        assert a.confidence == pytest.approx(b.confidence, rel=1e-5)
    assert [f.payload for f in tf] == [bytes(p.tolist()) for p in payloads]


def test_entry_points_default_to_the_card(tmp_path):
    """device=None means the card: without one, the new entry points raise
    where they would put data there; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is satisfied")
    from lora_tpu_torch.hw.capture import replay_file
    from lora_tpu_torch.ops import dcblock, resample
    from lora_tpu_torch.runtime import demodulate_bank

    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    x = np.zeros((1, 4096), np.complex64)
    f = tmp_path / "cap.cf32"
    f.write_bytes(np.zeros(4096, np.float32).tobytes())
    calls = [
        lambda: TStream(cfg, channels=1),
        lambda: demodulate_bank(x.real, x.imag, cfg),
        lambda: replay_file(str(f), "cf32", cfg),
        lambda: resample.resample(x, 2.0),
        lambda: dcblock.dcblock(x),
    ]
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError),
                           match="CUDA|cuda|NVIDIA"):
            call()
