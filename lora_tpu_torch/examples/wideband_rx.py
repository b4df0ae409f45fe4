"""Wideband multi-channel receive, BASELINE config 3 as a runnable demo
(port of examples/wideband_rx.py): a 16-channel grid carrying frames on
three channels, channelized (kernel D on the card) and demodulated (kernels
A, B, C) in one call, then batch-decoded.

    python -m lora_tpu_torch.examples.wideband_rx [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..tools import pick_device

MESSAGES = {3: b"hello ch 3", 8: b"greetings 8", 12: b"twelve here"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lora_tpu_torch.examples.wideband_rx",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = pick_device(args.device, "wideband_rx")

    import torch

    from .. import api
    from ..config import LoRaConfig
    from ..ops import channelizer as chz
    from ..utils.trace import frame_events

    K = 16
    cfg = LoRaConfig(sf=7, cr="4/7", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(11) + 4)
    rng = np.random.default_rng(42)

    # buffer must hold the demod window *after* the latest frame offset
    need = api.required_samples(cfg) + 100 * max(MESSAGES) + 256
    wide = None
    print(f"TX: {len(MESSAGES)} frames on a {K}-channel grid")
    for c, msg in MESSAGES.items():
        p = np.frombuffer(msg.ljust(11), np.uint8)
        nb = api.modulate(api.encode(p[None], cfg, device=device), cfg)[0]
        nb = torch.nn.functional.pad(
            nb, (100 * c, need - nb.shape[-1] - 100 * c))
        up = chz.upconvert(nb, K, c)
        wide = up if wide is None else wide + up
    T = (wide.shape[-1] // K) * K
    nz = torch.from_numpy(
        0.05 * rng.standard_normal((2, T)).astype(np.float32)).to(device)
    wide = wide[:T] + torch.complex(nz[0], nz[1])
    print(f"    wideband capture: {T} samples at {K}x channel rate")

    dem, _ = api.channelized_demodulate(wide, K, cfg)
    dec = api.decode(dem.symbols, cfg)
    got = api.extract_payloads(dec)
    for ev in frame_events(dem, cfg):
        c = ev["channel"]
        print(
            f"RX: ch {c:2d}  t_sync {ev['t_sync']:6d}  snr {ev['snr_db']:6.1f} dB"
            f"  payload {got[c]!r}"
        )
    ok = all(got[c] is not None and got[c].rstrip() == m
             for c, m in MESSAGES.items())
    print("byte-exact:", ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
