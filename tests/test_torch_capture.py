"""The port's capture harness (lora_tpu_torch.hw: capture, rn2483) and its
renderers against lora_tpu's on the same inputs: the replay, burst, FM and
radio cases of tests/test_cli_and_utils.py, and capture replay through the
integer-ratio channelizer (kernel D's route; its plain version here).
Frame fields equal; the host tools (burst_bounds, fm_discriminate, the
RN2483 driver) are copies and give equal results."""

import numpy as np
import pytest
import torch

from lora_tpu.config import LoRaConfig
from lora_tpu.hw import capture as jcap
from lora_tpu_torch import api as tapi
from lora_tpu_torch.hw import capture as tcap

torch.set_num_threads(1)


def frame(cfg, payload):
    return tapi.modulate(tapi.encode(np.frombuffer(payload, np.uint8)[None],
                                     cfg, device="cpu"), cfg)[0].numpy()


def frame_key(f):
    return (f.channel, f.t_start, f.data_start, f.freq_error, f.payload,
            f.status, tuple(int(s) for s in f.symbols))


def replays(path, fmt, cfg, **kw):
    tf = tcap.replay_file(path, fmt, cfg, device="cpu", **kw)
    jf = jcap.replay_file(path, fmt, cfg, **kw)
    assert [frame_key(f) for f in tf] == [frame_key(f) for f in jf]
    return tf


def test_replay_cs16_format_matches_jax(tmp_path):
    cfg = LoRaConfig(sf=8, cr="4/6", ampl=0.5)
    cfg = cfg.replace(mtu=cfg.num_symbols(6) + 2)
    x = np.concatenate([np.zeros(777, np.complex64), frame(cfg, b"replay"),
                        np.zeros(9000, np.complex64)])
    inter = np.empty(x.size * 2, np.int16)
    inter[0::2] = np.round(x.real * 32767 * 0.9).astype(np.int16)
    inter[1::2] = np.round(x.imag * 32767 * 0.9).astype(np.int16)
    f = tmp_path / "cap.cs16"
    f.write_bytes(inter.tobytes())
    frames = replays(str(f), "cs16", cfg)
    assert len(frames) == 1 and frames[0].payload == b"replay"


@pytest.mark.parametrize("K,channel,chunk", [(4, 1, 1 << 22), (8, 3, 6000)])
def test_replay_integer_ratio_channelizes_matches_jax(tmp_path, K, channel,
                                                      chunk):
    """A capture at K times the channel rate with a frame on one channel:
    replay channelizes it (the filter state carried across the seams of
    chunks of `chunk` capture samples) and decodes the selected channel,
    as lora_tpu does."""
    from lora_tpu_torch.ops import channelizer as chz

    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(6) + 2)
    nb = np.concatenate([np.zeros(300, np.complex64), frame(cfg, b"chanK!"),
                         np.zeros(3000, np.complex64)])
    wide = chz.upconvert(torch.as_tensor(nb), K, channel).numpy()
    g = np.random.default_rng(K)
    wide = (wide + 0.01 * (g.standard_normal(wide.size)
                           + 1j * g.standard_normal(wide.size))).astype(
        np.complex64)
    inter = np.empty(wide.size * 2, np.float32)
    inter[0::2], inter[1::2] = wide.real, wide.imag
    f = tmp_path / "cap.cf32"
    f.write_bytes(inter.tobytes())
    frames = replays(str(f), "cf32", cfg, capture_rate=K * 1e5,
                     channel_rate=1e5, channel=channel, chunk=chunk)
    assert [fr.payload for fr in frames] == [b"chanK!"]


def test_burst_bounds_matches_jax():
    rng = np.random.default_rng(9)
    re = 0.01 * rng.standard_normal(64 * 1024).astype(np.float32)
    im = 0.01 * rng.standard_normal(64 * 1024).astype(np.float32)
    re[20000:30000] += 1.0
    a, b = tcap.burst_bounds(re, im)
    assert (a, b) == jcap.burst_bounds(re, im)
    assert a <= 20000 < 30000 <= b and b - a < 15000


def test_fm_discriminator_reads_chirp_sawtooth_matches_jax():
    from lora_tpu_torch.ops import chirp

    N = 256
    up = chirp.dechirp_table(N, True, "cpu").numpy()  # the base upchirp
    freq, amp = tcap.fm_discriminate(up.real, up.imag)
    jfreq, jamp = jcap.fm_discriminate(up.real, up.imag)
    np.testing.assert_array_equal(freq, jfreq)
    np.testing.assert_array_equal(amp, jamp)
    d = np.diff(freq[2:])
    wrap = np.abs(d) > np.pi
    assert wrap.sum() <= 1
    assert abs(np.median(d[~wrap]) - 2 * np.pi / N) < 1e-3


def test_render_fm_plot_port(tmp_path):
    pytest.importorskip("matplotlib")
    from lora_tpu_torch.utils.plots import render_fm

    rng = np.random.default_rng(3)
    re = 0.01 * rng.standard_normal(8192).astype(np.float32)
    im = 0.01 * rng.standard_normal(8192).astype(np.float32)
    t = np.arange(2048, dtype=np.float32)
    re[3000:5048] += np.cos(0.001 * t * t)
    im[3000:5048] += np.sin(0.001 * t * t)
    render_fm(torch.as_tensor(re), torch.as_tensor(im),
              str(tmp_path / "fm.png"))
    assert (tmp_path / "fm.png").stat().st_size > 1000


class FakeSerial:
    def __init__(self):
        self.lines = []
        self.replies = []

    def write(self, b):
        cmd = b.decode().strip()
        self.lines.append(cmd)
        if cmd == "sys reset":
            self.replies.append(b"RN2483 1.0.5\r\n")
        elif cmd == "mac pause":
            self.replies.append(b"4294967245\r\n")
        elif cmd.startswith("radio tx"):
            self.replies.append(b"ok\r\n")
            self.replies.append(b"radio_tx_ok\r\n")
        else:
            self.replies.append(b"ok\r\n")

    def readline(self):
        return self.replies.pop(0) if self.replies else b""

    def close(self):
        pass


def test_rn2483_mac_pause_per_transmit_matches_jax():
    """The driver (a copy) sends the JAX package's command lines: `mac
    pause` before every radio tx, and the same config sequence."""
    from lora_tpu.hw import rn2483 as jrn
    from lora_tpu_torch.hw import rn2483 as trn

    sent = []
    for mod in (trn, jrn):
        radio = mod.RN2483.__new__(mod.RN2483)
        radio._ser = FakeSerial()
        radio.config(sf=9, cr="4/5", sync=0x34)
        radio.transmit(b"\x01\x02")
        radio.transmit(b"\x03")
        lines = radio._ser.lines
        txs = [i for i, l in enumerate(lines) if l.startswith("radio tx")]
        assert len(txs) == 2 and all(lines[i - 1] == "mac pause" for i in txs)
        sent.append(lines)
    assert sent[0] == sent[1]
    with pytest.raises(RuntimeError, match="pyserial"):
        trn.RN2483("/dev/null")


def test_soapy_capture_needs_soapysdr():
    """Without SoapySDR, recording raises a clear error; nothing else of
    the harness needs it."""
    try:
        import SoapySDR  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="SoapySDR"):
            tcap.SoapyCapture().record(0.01)
    else:
        pytest.skip("SoapySDR is installed")
