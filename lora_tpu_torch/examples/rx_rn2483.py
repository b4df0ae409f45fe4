"""Receive-only SDR chain (port of examples/rx_rn2483.py), the headless
equivalent of the reference's rx_RN2483.pth topology: SDR source at 500
kHz bandwidth -> DC removal -> demodulator, printing every decoded frame
(an RN2483 as the golden transmitter: python -m lora_tpu_torch.hw.rn2483).

    python -m lora_tpu_torch.examples.rx_rn2483 [--driver lime]
        [--freq 863.1e6] [--device cpu]

Needs the SoapySDR python module, imported by hw/capture when the first
block is recorded.
"""

from __future__ import annotations

import argparse
import sys

from ..tools import pick_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lora_tpu_torch.examples.rx_rn2483",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--driver", default="lime")
    ap.add_argument("--freq", type=float, default=863.1e6)
    ap.add_argument("--rate", type=float, default=500e3)
    ap.add_argument("--gain", type=float, default=50.0)
    ap.add_argument("--sf", type=int, default=11)
    ap.add_argument("--sync", type=lambda s: int(s, 0), default=0x12)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = pick_device(args.device, "rx_rn2483")

    from ..config import LoRaConfig
    from ..hw.capture import SoapyCapture
    from ..ops import dcblock
    from ..runtime import StreamDemodulator, decode_frames

    cfg = LoRaConfig(sf=args.sf, cr="4/7", sync=args.sync, ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(64) + 4)
    sdr = SoapyCapture(driver=args.driver, rate=args.rate, freq=args.freq,
                       gain=args.gain)
    sd = StreamDemodulator(cfg, channels=1, device=device)
    print(f"listening on {args.freq/1e6:.3f} MHz, SF{args.sf}, "
          f"sync 0x{args.sync:02x} ... Ctrl-C to stop")
    dstate = None
    try:
        while True:
            re, im = sdr.record(args.seconds)
            # DC removal (the topology's dc_removal block): a streaming
            # one-pole blocker, its state carried across record() blocks
            y, dstate = dcblock.dcblock((re, im), state=dstate,
                                        device=device)
            sd.feed(y[None])
            for f in decode_frames(list(sd.run()), cfg, device=device):
                print(f"t={f.t_start} snr={f.snr:.1f} dB cfo={f.freq_error} "
                      f"status={f.status} payload={f.payload!r}")
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
