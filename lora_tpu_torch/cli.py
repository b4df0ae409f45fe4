"""Command-line applications of the port (port of lora_tpu/cli.py).

The reference ships its applications as Pothos GUI topology graphs
(examples/*.pth: simulation loopback with AWGN + rotate, RX only,
two-radio relay/client).  The same end-to-end configurations run headless:

    python -m lora_tpu_torch.cli loopback  --sf 10 --cr 4/8 --noise 4.0
    python -m lora_tpu_torch.cli ber-sweep --sf 7 8 9 --cr 4/8 --points 8
    python -m lora_tpu_torch.cli tx        --sf 7 --payload 48656c6c6f --out f.cf32
    python -m lora_tpu_torch.cli replay    --file f.cf32 --fmt cf32 --sf 7

Each runs on --device (the card by default; --device cpu, in place of
lora_tpu's --cpu, runs the plain PyTorch versions on the host).  `bench` is
not ported yet and says so.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _cfg_from(args, payload_len: int):
    from .config import LoRaConfig

    cfg = LoRaConfig(
        sf=args.sf if isinstance(args.sf, int) else args.sf[0],
        cr=args.cr if isinstance(args.cr, str) else args.cr[0],
        ampl=1.0,
        sync=args.sync,
    )
    return cfg.replace(mtu=cfg.num_symbols(payload_len) + 4)


def cmd_loopback(args) -> int:
    """encode -> modulate -> AWGN(+rotate/CFO/delay) -> demodulate -> decode,
    the lora_simulation.pth topology headless (TestLoopback operating point
    by default)."""
    from . import api
    from .utils import TestGen

    payload = TestGen().batch(args.packets, pad_to=args.length)
    cfg = _cfg_from(args, payload.shape[1])
    dec, dem = api.loopback(
        payload,
        cfg,
        noise_amplitude=args.noise,
        phase=args.phase,
        cfo_bins=args.cfo,
        delay=args.delay,
        seed=args.seed,
        debug=bool(args.dump_spectra),
        soft=args.soft,
        device=args.device,
    )
    if args.dump_spectra:
        from .utils.plots import render_taps

        render_taps(dem, cfg, args.dump_spectra)
    got = api.extract_payloads(dec)
    ok = sum(1 for g, p in zip(got, payload) if g == bytes(p.tolist()))
    m = {k: float(v) for k, v in
         api.aggregate_metrics(dem, statuses=dec.status).items()}
    print(json.dumps({"packets": args.packets, "byte_exact": ok, **m}))
    return 0 if ok == args.packets else 1


def cmd_ber_sweep(args) -> int:
    """Frame/byte error rate vs noise amplitude for SF x CR grids (the
    reference's verified operating point is signal 1.0 / noise 4.0 at SF10,
    TestLoopback.cpp:97-99)."""
    from . import api
    from .config import LoRaConfig

    rng = np.random.default_rng(args.seed)
    rows = []
    for sf in args.sf:
        # one mtu across the CR axis, as the JAX package sweeps
        mtu = max(
            LoRaConfig(sf=sf, cr=c).num_symbols(args.length) for c in args.cr
        ) + 4
        for cr in args.cr:
            cfg = LoRaConfig(sf=sf, cr=cr, ampl=1.0, sync=args.sync)
            cfg = cfg.replace(mtu=mtu)
            payload = rng.integers(
                0, 256, (args.packets, args.length)
            ).astype(np.uint8)
            # noise grid: around the matched-filter threshold, which scales
            # with sqrt(N); the reference point (SF10, a=4) sits mid-grid
            base = 4.0 * np.sqrt(cfg.N / 1024.0)
            for a in np.linspace(base * 0.5, base * 1.75, args.points):
                dec, dem = api.loopback(
                    payload, cfg, noise_amplitude=float(a), seed=args.seed,
                    device=args.device,
                )
                got = api.extract_payloads(dec)
                fer = 1.0 - sum(
                    g == bytes(p.tolist()) for g, p in zip(got, payload)
                ) / args.packets
                # per-bit BER conditioned on sync: XOR the decoded payload
                # bytes (position 3 after the explicit header, even when
                # the CRC failed) against the sent bytes
                found = dem.found.cpu().numpy()
                data = dec.data.cpu().numpy()
                bits = errs = 0
                for i in range(args.packets):
                    if not found[i]:
                        continue
                    raw = data[i, 3 : 3 + args.length].astype(np.uint8)
                    errs += int(np.unpackbits(raw ^ payload[i]).sum())
                    bits += 8 * args.length
                snr_db = 10 * np.log10(1.0 / (2 * a * a))
                rows.append(
                    {
                        "sf": sf,
                        "cr": cr,
                        "noise_ampl": round(float(a), 3),
                        "snr_db": round(float(snr_db), 2),
                        "fer": round(float(fer), 4),
                        "ber": round(errs / bits, 6) if bits else None,
                        "synced": int(found.sum()),
                    }
                )
                print(json.dumps(rows[-1]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


def tx_samples(payload: bytes, cfg, device=None) -> np.ndarray:
    """One frame of `payload`, modulated on `device`, as interleaved cf32
    host samples (the body of a `tx` file)."""
    from . import api
    from .ops import cplx
    from .runtime import iqio

    iq = api.modulate(
        api.encode(np.frombuffer(payload, np.uint8)[None], cfg,
                   device=device), cfg)
    return iqio.interleave_cf32(*cplx.to_planar(iq[0]))


def cmd_tx(args) -> int:
    """Generate a frame waveform to an interleaved cf32 file."""
    payload = bytes.fromhex(args.payload)
    cfg = _cfg_from(args, len(payload))
    data = tx_samples(payload, cfg, args.device)
    with open(args.out, "wb") as f:
        if args.lead_in:
            f.write(np.zeros(2 * args.lead_in, np.float32).tobytes())
        f.write(data.tobytes())
        if args.lead_out:
            f.write(np.zeros(2 * args.lead_out, np.float32).tobytes())
    print(json.dumps({"samples": data.size // 2, "file": args.out}))
    return 0


def cmd_replay(args) -> int:
    """Decode every frame of a capture file (optionally channelized)."""
    from .hw.capture import burst_bounds, replay_file
    from .runtime import iqio

    cfg = _cfg_from(args, args.length)
    if args.fm_plot:
        # waveform forensics: FM-discriminate the first burst of the
        # capture (the reference's RN2483Capture.py:80-97 diagnostic)
        from .utils.plots import render_fm

        itemsize = {"cs8": 1, "cu8": 1, "cs16": 2, "cf32": 4}[args.fmt]
        with open(args.file, "rb") as f:
            raw = f.read((1 << 22) * 2 * itemsize)
        re, im = iqio.convert(raw, args.fmt)
        a, b = burst_bounds(re, im)
        if b > a:
            re, im = re[a:b], im[a:b]
        render_fm(re, im, args.fm_plot)
        print(json.dumps({"fm_plot": args.fm_plot,
                          "burst": [int(a), int(b)]}))
    observer = None
    if args.live:
        from .utils.live import LiveTapView

        observer = LiveTapView(channels=1)
    frames = replay_file(
        args.file,
        args.fmt,
        cfg,
        capture_rate=args.capture_rate,
        channel_rate=args.channel_rate,
        channel=args.channel,
        soft=args.soft,
        dc_block=args.dc_block,
        observer=observer,
        device=args.device,
    )
    for f in frames:
        print(
            json.dumps(
                {
                    "t_start": f.t_start,
                    "snr_db": round(f.snr, 2),
                    "cfo_bins": f.freq_error,
                    "status": f.status,
                    "payload": f.payload.hex() if f.payload else None,
                    **(
                        {"confidence": round(f.confidence, 1)}
                        if f.confidence is not None else {}
                    ),
                }
            )
        )
    print(json.dumps({"frames": len(frames)}))
    return 0


def cmd_bench(args) -> int:
    from .roadmap import not_ported

    raise not_ported("bench", 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lora_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, multi_sfcr=False):
        if multi_sfcr:
            p.add_argument("--sf", type=int, nargs="+", default=[10])
            p.add_argument("--cr", nargs="+", default=["4/8"])
        else:
            p.add_argument("--sf", type=int, default=10)
            p.add_argument("--cr", default="4/8")
        p.add_argument("--sync", type=lambda s: int(s, 0), default=0x12)
        p.add_argument("--length", type=int, default=20)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument(
            "--device", default=None,
            help="torch device to run on (default: the card; 'cpu' runs "
                 "the plain PyTorch versions on the host)",
        )

    p = sub.add_parser("loopback", help=cmd_loopback.__doc__)
    common(p)
    p.add_argument("--packets", type=int, default=5)
    p.add_argument("--noise", type=float, default=4.0)
    p.add_argument("--phase", type=float, default=np.pi / 1.2345)
    p.add_argument("--cfo", type=float, default=0.0)
    p.add_argument("--delay", type=int, default=0)
    p.add_argument(
        "--dump-spectra", metavar="PNG",
        help="render the demod raw/dec/fft debug taps to this file",
    )
    p.add_argument(
        "--soft", action="store_true",
        help="decode with the soft-decision path (ML codewords from the "
             "demod spectra)",
    )
    p.set_defaults(fn=cmd_loopback)

    p = sub.add_parser("ber-sweep", help=cmd_ber_sweep.__doc__)
    common(p, multi_sfcr=True)
    p.add_argument("--packets", type=int, default=50)
    p.add_argument("--points", type=int, default=6)
    p.add_argument("--out")
    p.set_defaults(fn=cmd_ber_sweep)

    p = sub.add_parser("tx", help=cmd_tx.__doc__)
    common(p)
    p.add_argument("--payload", required=True, help="hex bytes")
    p.add_argument("--out", required=True)
    p.add_argument("--lead-in", type=int, default=4096)
    p.add_argument("--lead-out", type=int, default=4096)
    p.set_defaults(fn=cmd_tx)

    p = sub.add_parser("replay", help=cmd_replay.__doc__)
    common(p)
    p.add_argument("--file", required=True)
    p.add_argument("--fmt", default="cf32", choices=["cs8", "cu8", "cs16", "cf32"])
    p.add_argument("--capture-rate", type=float)
    p.add_argument("--channel-rate", type=float)
    p.add_argument("--channel", type=int, default=0)
    p.add_argument(
        "--soft", action="store_true",
        help="soft-decision decode (frames report an ML confidence margin)",
    )
    p.add_argument(
        "--dc-block", action="store_true",
        help="one-pole DC blocker before channelizing (zero-IF tuner "
             "spike removal, the reference topology's dc_removal stage)",
    )
    p.add_argument(
        "--fm-plot", metavar="PNG",
        help="render the FM-discriminated first burst (waveform "
             "forensics, RN2483Capture.py:80-97) to this file",
    )
    p.add_argument(
        "--live", action="store_true",
        help="terminal live-tap dashboard while replaying",
    )
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("bench", help="not ported yet (ROADMAP.md item 1)")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
