"""SDR capture harness: golden-TX transmit + wideband capture + decode (port of
lora_tpu/hw/capture.py).

The reference's RN2483Capture.py (24-101) transmits through the RN2483 and
records through SoapySDR/RTL-SDR with a std-dev burst detector.  This
harness keeps that role and adds the production path: captured or
file-replayed samples go through the native ingest converters
(runtime/iqio.py) onto the device, through the DC blocker, the channelizer
(kernel D) or the fractional resampler, into the streaming demodulator.

SoapySDR is imported lazily; capture-file replay works without it.
`burst_bounds` and `fm_discriminate` are host numpy, copies of the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..config import LoRaConfig
from ..ops import cplx
from ..runtime import StreamDemodulator, decode_frames, iqio
from ..runtime.stream import Frame


def burst_bounds(
    re: np.ndarray, im: np.ndarray, window: int = 1024, k: float = 4.0
) -> tuple[int, int]:
    """Std-dev burst detector (RN2483Capture.py:45-53): first/last window
    whose RMS exceeds k x the noise floor estimate."""
    n = (re.size // window) * window
    p = (re[:n] ** 2 + im[:n] ** 2).reshape(-1, window).mean(axis=1)
    floor = np.median(p)
    hot = np.nonzero(p > k * k * floor)[0]
    if hot.size == 0:
        return 0, 0
    return int(hot[0] * window), int((hot[-1] + 1) * window)


def fm_discriminate(
    re: np.ndarray, im: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """FM discriminator: per-sample instantaneous frequency (radians per
    sample, in [-pi, pi)) and amplitude envelope of a capture.

    The reference's waveform-forensics tool (RN2483Capture.py:80-97 plots
    the frequency-discriminated burst — this is how the whitening/CRC
    tables in LoRaCodes.hpp were reverse-engineered: a LoRa chirp shows up
    as a clean sawtooth whose resets encode the symbol values).  Computed
    as arg(x[n] * conj(x[n-1])), vectorized; element 0 is 0."""
    re = np.asarray(re, np.float32)
    im = np.asarray(im, np.float32)
    # x[n] * conj(x[n-1]) without materializing complex128
    pr = re[1:] * re[:-1] + im[1:] * im[:-1]
    pi_ = im[1:] * re[:-1] - re[1:] * im[:-1]
    freq = np.concatenate([[0.0], np.arctan2(pi_, pr)]).astype(np.float32)
    amp = np.hypot(re, im).astype(np.float32)
    return freq, amp


def replay_file(
    path: str,
    fmt: str,
    cfg: LoRaConfig,
    capture_rate: float | None = None,
    channel_rate: float | None = None,
    channel: int = 0,
    chunk: int = 1 << 22,
    soft: bool = False,
    dc_block: bool = False,
    observer=None,
    device=None,
) -> list[Frame]:
    """Decode every frame of a recorded capture file on `device` (the card
    when None).

    observer: optional StreamDemodulator step hook (e.g.
    utils.live.LiveTapView), the headless analogue of the reference's GUI
    plotters.

    fmt: cs8 | cu8 | cs16 | cf32 (interleaved wire format).  Each chunk is
    converted on the host (runtime/iqio), copied to the device once, and
    stays there.  If capture_rate > channel_rate: an integer ratio K
    channelizes the stream (K channels through kernel D on the card,
    `channel` selects one); a fractional ratio resamples the capture down to
    the channel rate (the RN2483Capture 2.048 Msps use case).  Both carry
    their filter state across chunks, so a frame may straddle any number of
    chunk boundaries.

    dc_block=True high-passes the capture with the streaming one-pole DC
    blocker before channelizing (the reference RX topology's dc_removal
    stage, examples/rx_RN2483.pth); its state carries across chunks too.
    """
    from ..ops import channelizer as chz
    from ..ops import dcblock as dcb
    from ..ops import resample as rs

    dev = cplx.resolve_device(device)
    K = 1
    ratio = 1.0
    if capture_rate and channel_rate and capture_rate != channel_rate:
        ratio = capture_rate / channel_rate
        if abs(ratio - round(ratio)) < 1e-9 and ratio >= 2:
            K = int(round(ratio))
            ratio = 1.0
    sd = StreamDemodulator(cfg, channels=1, soft=soft, observer=observer,
                           device=dev)
    state = None
    rstate = None
    dstate = None
    frames: list[Frame] = []
    itemsize = {"cs8": 1, "cu8": 1, "cs16": 2, "cf32": 4}[fmt]
    with open(path, "rb") as f:
        while True:
            raw = f.read(chunk * 2 * itemsize)
            if not raw:
                break
            x = cplx.from_planar(*iqio.convert(raw, fmt), dev)
            if dc_block:
                x, dstate = dcb.dcblock(x, state=dstate)
            if K > 1:
                T = (x.shape[-1] // K) * K
                y, state = chz.channelize(x[:T], K, state=state)
                sd.feed(y[channel][None])
            elif ratio != 1.0:
                nb, rstate = rs.resample_stream(x, ratio, rstate)
                if nb.shape[-1]:
                    sd.feed(nb[None])
            else:
                sd.feed(x[None])
            frames.extend(sd.run())
    frames.extend(sd.flush())
    return decode_frames(frames, cfg, dev)


@dataclasses.dataclass
class SoapyCapture:
    """Record from a SoapySDR device (RTL-SDR, LimeSDR, ...)."""

    driver: str = "rtlsdr"
    rate: float = 2.048e6
    freq: float = 868.1e6
    gain: Optional[float] = None

    def record(self, seconds: float) -> tuple[np.ndarray, np.ndarray]:
        try:
            import SoapySDR
            from SoapySDR import SOAPY_SDR_RX, SOAPY_SDR_CF32
        except ImportError as e:  # pragma: no cover - hardware optional
            raise RuntimeError("capture needs the SoapySDR python module") from e
        dev = SoapySDR.Device({"driver": self.driver})
        dev.setSampleRate(SOAPY_SDR_RX, 0, self.rate)
        dev.setFrequency(SOAPY_SDR_RX, 0, self.freq)
        if self.gain is not None:
            dev.setGain(SOAPY_SDR_RX, 0, self.gain)
        stream = dev.setupStream(SOAPY_SDR_RX, SOAPY_SDR_CF32)
        dev.activateStream(stream)
        total = int(seconds * self.rate)
        ring = iqio.IqRing(2 * total)
        buf = np.empty(1 << 17, np.complex64)
        got = 0
        while got < total:
            sr = dev.readStream(stream, [buf], buf.size)
            if sr.ret > 0:
                ring.write(
                    buf[: sr.ret].real.astype(np.float32),
                    buf[: sr.ret].imag.astype(np.float32),
                )
                got += sr.ret
        dev.deactivateStream(stream)
        dev.closeStream(stream)
        return ring.read(got)

    def transmit_and_collect(
        self, radio, payload: bytes, seconds: float = 0.5
    ) -> tuple[np.ndarray, np.ndarray]:
        """RN2483 TX + SDR RX, trimmed to the burst
        (RN2483Capture.py:24-56)."""
        import threading

        out: dict = {}

        def rx():
            out["iq"] = self.record(seconds)

        t = threading.Thread(target=rx)
        t.start()
        time.sleep(0.05)
        radio.transmit(payload)
        t.join()
        re, im = out["iq"]
        a, b = burst_bounds(re, im)
        return re[a:b], im[a:b]
