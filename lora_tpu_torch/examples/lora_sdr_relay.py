"""Two-radio chat relay (port of examples/lora_sdr_relay.py), the headless
equivalent of the reference's lora_sdr_relay.pth / lora_sdr_client.pth
topologies: a full RX chain on one frequency and a full TX chain on another
over a LimeSDR, the relay and the client on swapped frequencies and sync
words.

Topology globals (lora_sdr_relay.pth): SF11, PPM = SF-2, CR 4/7, BW 500
kHz, RX 863.1 MHz sync 0x3c / TX 873.1 MHz sync 0x4e (the client swaps
them: --role client).

    python -m lora_tpu_torch.examples.lora_sdr_relay --role relay
        [--driver lime] [--device cpu]

Needs the SoapySDR python module, imported only when the relay starts.
"""

from __future__ import annotations

import argparse
import sys
import threading

import numpy as np

from ..tools import pick_device

SF, CR, BW = 11, "4/7", 500e3
FREQ_A, FREQ_B = 863.1e6, 873.1e6
SYNC_A, SYNC_B = 0x3C, 0x4E


def make_cfg(sync: int):
    from ..config import LoRaConfig

    cfg = LoRaConfig(sf=SF, ppm=SF - 2, cr=CR, sync=sync, ampl=0.7)
    return cfg.replace(mtu=cfg.num_symbols(64) + 4)


def soapy():
    try:
        import SoapySDR
    except ImportError as e:
        raise RuntimeError("lora_sdr_relay needs the SoapySDR python "
                           "module") from e
    return SoapySDR


def rx_loop(dev, freq, cfg, on_frame, device):
    from SoapySDR import SOAPY_SDR_CF32, SOAPY_SDR_RX

    from ..runtime import StreamDemodulator, decode_frames

    dev.setSampleRate(SOAPY_SDR_RX, 0, BW)
    dev.setFrequency(SOAPY_SDR_RX, 0, freq)
    stream = dev.setupStream(SOAPY_SDR_RX, SOAPY_SDR_CF32)
    dev.activateStream(stream)
    sd = StreamDemodulator(cfg, channels=1, device=device)
    buf = np.empty(1 << 16, np.complex64)
    while True:
        sr = dev.readStream(stream, [buf], buf.size)
        if sr.ret <= 0:
            continue
        sd.feed(buf[: sr.ret][None])
        for f in decode_frames(list(sd.run()), cfg, device=device):
            if f.payload is not None:
                on_frame(f)


def tx_frame(dev, freq, cfg, payload: bytes, device):
    from SoapySDR import SOAPY_SDR_CF32, SOAPY_SDR_TX

    from .. import api

    dev.setSampleRate(SOAPY_SDR_TX, 0, BW)
    dev.setFrequency(SOAPY_SDR_TX, 0, freq)
    iq = api.modulate(api.encode(np.frombuffer(payload, np.uint8)[None], cfg,
                                 device=device), cfg)
    data = iq[0].cpu().numpy()
    stream = dev.setupStream(SOAPY_SDR_TX, SOAPY_SDR_CF32)
    dev.activateStream(stream)
    dev.writeStream(stream, [data], data.size)
    dev.deactivateStream(stream)
    dev.closeStream(stream)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lora_tpu_torch.examples.lora_sdr_relay",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--role", choices=["relay", "client"], default="relay")
    ap.add_argument("--driver", default="lime")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = pick_device(args.device, "lora_sdr_relay")
    dev = soapy().Device({"driver": args.driver})
    if args.role == "relay":
        rx_freq, rx_sync, tx_freq, tx_sync = FREQ_A, SYNC_A, FREQ_B, SYNC_B
    else:
        rx_freq, rx_sync, tx_freq, tx_sync = FREQ_B, SYNC_B, FREQ_A, SYNC_A

    rx_cfg, tx_cfg = make_cfg(rx_sync), make_cfg(tx_sync)

    def on_frame(f):
        print(f"rx: {f.payload!r} (snr {f.snr:.1f} dB)")

    threading.Thread(
        target=rx_loop, args=(dev, rx_freq, rx_cfg, on_frame, device),
        daemon=True).start()
    print(f"{args.role}: rx {rx_freq/1e6:.1f} MHz/0x{rx_sync:02x}, "
          f"tx {tx_freq/1e6:.1f} MHz/0x{tx_sync:02x}; type to send")
    for line in sys.stdin:
        line = line.strip()
        if line:
            tx_frame(dev, tx_freq, tx_cfg, line.encode(), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
