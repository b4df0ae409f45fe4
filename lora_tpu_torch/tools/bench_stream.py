"""Sustained ingest of the streaming runtime (port of tools/bench_stream.py).

    python -m lora_tpu_torch.tools.bench_stream [--device cpu] [--B 0]
        [--sf 0] [--skip-ingest]

bench_ingest: the stream's ring (runtime/stream._Ring, on the host here)
appending blocks while a consumer keeps up, against the concatenating
design (np.concatenate a feed, slice trim).  Host work on any machine.

bench_pump: StreamDemodulator.pump (an ingest thread converting host
blocks into pinned staging while the steps run) against the serial
feed/run loop, on the device: B channels (256 on the card, 16 on the CPU)
of six frames each at SF10 (SF7 on the CPU) with AWGN 0.05, fed in blocks
of 65,536 samples from a complex64 wire source (SoapySDR's CF32) and from
a planar (re, im) source.  Each line gives the Msamples/s of B * T over
the wall time of one pass after a warm-up pass, the frames and the ratio
against the serial loop; the functions also return the records.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import device_label, pick_device


def bench_ingest(B: int = 64, chunk: int = 8192, total: int = 1 << 24
                 ) -> dict:
    """Ring against concatenate on the host; prints lora_tpu's two lines."""
    import torch

    from ..runtime.stream import _Ring

    re = np.random.default_rng(0).standard_normal((B, chunk)).astype(
        np.float32)
    blk = torch.complex(torch.from_numpy(re), torch.from_numpy(re))

    # ring: the consumer keeps up (steady state: no growth, O(chunk) writes)
    ring = _Ring(B, 4 * chunk, chunk, "cpu")
    t0 = time.perf_counter()
    fed = 0
    while fed < total:
        ring.append(blk)
        ring.trim(ring.end - chunk)
        fed += chunk
    dt_ring = time.perf_counter() - t0

    # the concatenating design: np.concatenate a feed, then a slice trim
    bre = np.zeros((B, 0), np.float32)
    bim = np.zeros((B, 0), np.float32)
    t0 = time.perf_counter()
    fed = 0
    while fed < total:
        bre = np.concatenate([bre, re], axis=1)
        bim = np.concatenate([bim, re], axis=1)
        if bre.shape[1] > 4 * chunk:
            bre = bre[:, -4 * chunk:]
            bim = bim[:, -4 * chunk:]
        fed += chunk
    dt_cat = time.perf_counter() - t0

    rate = B * total / dt_ring / 1e6
    print(f"ring ingest : {rate:9.1f} Msamp/s  ({dt_ring*1e3:7.1f} ms for "
          f"{B}x{total / (1 << 20):g}M samples)")
    print(f"concatenate : {B * total / dt_cat / 1e6:9.1f} Msamp/s  "
          f"({dt_cat*1e3:7.1f} ms)   -> ring is {dt_cat/dt_ring:.1f}x")
    return {"ring_Msamp_s": rate, "ring_ms": dt_ring * 1e3,
            "concatenate_Msamp_s": B * total / dt_cat / 1e6,
            "concatenate_ms": dt_cat * 1e3, "ring_speedup": dt_cat / dt_ring}


def pump_bank(B: int, sf: int, device):
    """(cfg, host bank float32 [2, B, T] of six frames a channel, the
    payloads uint8 [B, 16], the frames a pass can find)."""
    from .. import api
    from ..config import LoRaConfig
    from ..models.demodulator import required_samples

    cfg = LoRaConfig(sf=sf, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 2)
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 256, (B, 16), dtype=np.uint8)
    iq = api.modulate(api.encode(payload, cfg, device=device), cfg).cpu()
    frame = np.stack([iq.real.numpy(), iq.imag.numpy()], 0)
    n_frames, gap = 6, 3000
    FL = frame.shape[-1]
    T = n_frames * (FL + gap) + 8 * cfg.N
    bank = np.zeros((2, B, T), np.float32)
    for i in range(n_frames):
        o = i * (FL + gap)
        bank[:, :, o : o + FL] = frame
    bank += 0.05 * rng.standard_normal(bank.shape).astype(np.float32)
    # a frame whose window runs past the stream's end is not demodulated
    # (no flush): at SF10 the sixth of each channel
    W = required_samples(cfg)
    reach = B * sum(i * (FL + gap) + W <= T for i in range(n_frames))
    return cfg, bank, payload, reach


def bench_pump(B: int = 0, sf: int = 0, device=None) -> list[dict]:
    """pump against serial feed/run on `device`; prints lora_tpu's lines
    (and the device), returns a record a line (with the frames the bank puts
    within the stream's reach, the pass's frames, the config and the sent
    payloads)."""
    from ..runtime import StreamDemodulator

    on_card = device.type == "cuda"
    B = B or (256 if on_card else 16)
    cfg, bank, payload, reach = pump_bank(B, sf or (10 if on_card else 7),
                                          device)
    T = bank.shape[-1]
    chunkn = 1 << 16
    # the SDR's wire source (CF32: one interleaved complex64 block a read):
    # feed() pays the conversion, which pump() moves into its thread
    wire = (bank[0] + 1j * bank[1]).astype(np.complex64)

    def blocks_planar():
        for i in range(0, T, chunkn):
            yield bank[0, :, i : i + chunkn], bank[1, :, i : i + chunkn]

    def blocks_wire():
        for i in range(0, T, chunkn):
            yield wire[:, i : i + chunkn]

    def serial(blocks):
        sd = StreamDemodulator(cfg, channels=B, device=device)
        out = []
        for blk in blocks():
            sd.feed(blk)
            out.extend(sd.run())
        return out

    def pipelined(blocks):
        sd = StreamDemodulator(cfg, channels=B, device=device)
        return list(sd.pump(blocks()))

    label = device_label(device)
    recs = []
    for src_name, blocks in (("wire cf32", blocks_wire),
                             ("planar IQ", blocks_planar)):
        base = None
        for name, fn in (("serial feed/run", serial),
                         ("pump (pipelined)", pipelined)):
            fn(blocks)  # warm-up
            t0 = time.perf_counter()
            frames = fn(blocks)
            dt = time.perf_counter() - t0
            rate = B * T / dt / 1e6
            if base is None:
                base = dt
            print(f"{src_name} {name:17s}: {rate:8.1f} Msamp/s  "
                  f"({len(frames)} frames, {dt*1e3:6.1f} ms, "
                  f"{base/dt:.2f}x vs serial) [{label}]", flush=True)
            recs.append({"source": src_name, "loop": name,
                         "Msamp_s": rate, "frames": len(frames),
                         "ms": dt * 1e3, "vs_serial": base / dt,
                         "B": B, "T": T, "sf": cfg.sf, "device": label,
                         "frames_in_reach": reach, "frame_list": frames,
                         "cfg": cfg, "payload": payload})
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lora_tpu_torch.tools.bench_stream",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device for bench_pump (default: the card)")
    ap.add_argument("--B", type=int, default=0)
    ap.add_argument("--sf", type=int, default=0)
    ap.add_argument("--skip-ingest", action="store_true")
    args = ap.parse_args(argv)
    device = pick_device(args.device, "bench_stream")
    if not args.skip_ingest:
        bench_ingest()
    bench_pump(args.B, args.sf, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
