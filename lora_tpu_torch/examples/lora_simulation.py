"""Full modem simulation loopback (port of examples/lora_simulation.py),
the headless equivalent of the reference's lora_simulation.pth topology:
encoder -> modulator -> AWGN + phase rotation -> demodulator -> decoder,
with live noise control and error/power/SNR displays.

Type a message on stdin and watch it cross the simulated channel.  Live
controls (the topology's sliders and globals):

    /noise X    AWGN amplitude (slider)
    /sf N       spreading factor 7-12 (global)
    /cr 4/7     coding rate 4/4..4/8 (global)
    /sync 0x8e  sync word (global)
    /show       print the current configuration

    python -m lora_tpu_torch.examples.lora_simulation [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..tools import pick_device

# lora_simulation.pth globals: SF10, MTU 20, sync 0x8e, CR 4/8, rotate pi/1.2345
SF, SYNC, CR, MTU_BYTES = 10, 0x8E, "4/8", 20
ROTATE = np.pi / 1.2345


def main(argv=None, lines=None) -> int:
    """Read commands and messages from `lines` (stdin when None)."""
    ap = argparse.ArgumentParser(
        prog="lora_tpu_torch.examples.lora_simulation",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = pick_device(args.device, "lora_simulation")

    from .. import api
    from ..config import LoRaConfig

    noise = 4.0
    sf, sync, cr = SF, SYNC, CR
    print(f"LoRa simulation: SF{sf} {cr} sync 0x{sync:02x}, noise={noise}")
    print("type text to transmit; /noise X, /sf N, /cr 4/7, /sync 0x8e,"
          " /show; Ctrl-D to exit")
    for line in sys.stdin if lines is None else lines:
        line = line.strip()
        if not line:
            continue
        if line.startswith("/"):
            try:
                cmd, *rest = line.split()
                if cmd == "/noise":
                    noise = float(rest[0])
                elif cmd == "/sf":
                    want = int(rest[0])
                    if not 7 <= want <= 12:
                        raise ValueError("sf must be 7..12")
                    sf = want
                elif cmd == "/cr":
                    want_cr = rest[0]
                    LoRaConfig(sf=sf, cr=want_cr)  # validate now, not at TX
                    cr = want_cr  # state mutates only on success
                elif cmd == "/sync":
                    sync = int(rest[0], 0) & 0xFF
                elif cmd != "/show":
                    print(f"[unknown command {cmd}]")
                    continue
            except (IndexError, ValueError) as e:
                print(f"[bad command: {e}]")
                continue
            print(f"[SF{sf} {cr} sync 0x{sync:02x} noise={noise}]")
            continue
        data = line.encode()[:MTU_BYTES]
        try:
            cfg = LoRaConfig(sf=sf, cr=cr, sync=sync, ampl=1.0)
        except ValueError as e:
            print(f"[invalid config: {e}]")
            continue
        cfg = cfg.replace(mtu=cfg.num_symbols(len(data)) + 4)
        payload = np.frombuffer(data, np.uint8)[None]
        dec, dem = api.loopback(payload, cfg, noise_amplitude=noise,
                                phase=ROTATE, device=device)
        got = api.extract_payloads(dec)[0]
        m = api.aggregate_metrics(dem, statuses=dec.status)
        print(
            f"  rx: {got.decode(errors='replace') if got else '<dropped>'}"
            f"   snr={float(dem.snr.reshape(-1)[0]):.1f} dB"
            f" power={float(dem.power.reshape(-1)[0]):.1f} dB"
            f" cfo={int(dem.freq_error.reshape(-1)[0])} bins"
            f" dropped={int(m['dropped'])}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
