"""Config 5 end to end, from an SDR's wire format to decoded frames (port of
tools/bench_e2e.py).

    python -m lora_tpu_torch.tools.bench_e2e [--channels 10240]
        [--slab 2048] [--payload 32] [--host-convert | --interleaved]
        [--minutes M] [--mixed-sf] [--device cpu]

Pipeline under test, on one card:

  ingest thread: cs16 wire -> the mode's host conversion, into pinned
                 buffers (runtime/staging.Staging: a buffer is written
                 again only after the CUDA event of its last copy) ->
                 queue of depth 2
  this thread:   copy to the card (non_blocking) -> the mode's device
                 conversion -> demodulate -> decode -> found, status and
                 length read back one slab later (a depth-1 pipeline)

Three transfer modes:
  --host-convert   runtime/iqio.convert, the native converter, turns cs16
                   into planar float32 on the host; 8 bytes a sample go
                   over the link
  --interleaved    the raw interleaved int16 wire goes over the link (4
                   bytes a sample); the card casts, scales and reads it as
                   complex64 in place
  (default)        the host splits cs16 into planar int16 (a strided copy
                   on the ingest thread); 4 bytes a sample over the link,
                   the card casts and scales

The wire is one slab of lora_tpu's construction (SF10 CR 4/8 frames of
--payload random bytes, mtu = num_symbols(payload) + 4, padded to
required_samples, AWGN 0.05 from numpy's generator seeded 0, quantized to
cs16 at x8192), reused for every slab.  --mixed-sf adds an SF8 group and
routes slabs round robin between the groups.  --minutes M cycles slabs for
M minutes of wall clock and reports the per-slab median, p95, max, drift
and RSS.

Printed: the end-to-end record (lora_tpu's keys, "bench": "config5_e2e",
plus the device's name and power limit), then the compute-only record:
the same device work on a resident slab, and the measured pinned
host-to-device rate of one slab in this mode with the Msamples/s that link
alone would carry (in place of lora_tpu's labelled PCIe projection).  On
the CPU (--device cpu) nothing crosses a link: the link keys read "not
measured".
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time

import numpy as np
import torch

from . import device_label, pick_device

SCALE = 1.0 / 8192.0
NOISE = 0.05
# mode -> (the record's name, bytes a complex sample over the link)
MODES = {
    "planar": ("planar-int16", 4),
    "host-convert": ("host-convert/f32", 8),
    "interleaved": ("device-deinterleave/int16", 4),
}
REPS = 4
H2D_REPS = 5


def make_group(sf: int, slab: int, payload: int, rng, device) -> dict:
    """One config group: its cfg, T and one slab of cs16 wire int16
    [slab, 2T] (tools/bench_e2e.py:96-120; the frames are the port's TX on
    `device`)."""
    from .. import api
    from ..config import LoRaConfig

    cfg = LoRaConfig(sf=sf, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(payload) + 4)
    T = api.required_samples(cfg)
    pay = rng.integers(0, 256, (slab, payload), dtype=np.uint8)
    iq = api.modulate(api.encode(pay, cfg, device=device), cfg)[:, :T]
    iq = torch.nn.functional.pad(iq, (0, T - iq.shape[1])).cpu().numpy()
    re = iq.real + NOISE * rng.standard_normal(iq.shape, dtype=np.float32)
    im = iq.imag + NOISE * rng.standard_normal(iq.shape, dtype=np.float32)
    wire = np.empty((slab, 2 * T), np.int16)
    wire[:, 0::2] = np.clip(re * 8192.0, -32768, 32767).astype(np.int16)
    wire[:, 1::2] = np.clip(im * 8192.0, -32768, 32767).astype(np.int16)
    return {"sf": sf, "cfg": cfg, "T": T, "wire": wire,
            "found": 0, "ok": 0, "slabs": 0}


def block_spec(g: dict, mode: str) -> tuple:
    """(shape, dtype) of one slab's host block in `mode`."""
    slab, T = g["wire"].shape[0], g["T"]
    if mode == "interleaved":
        return (slab, 2 * T), torch.int16
    return (2, slab, T), torch.float32 if mode == "host-convert" \
        else torch.int16


def fill(g: dict, mode: str, buf: torch.Tensor) -> None:
    """The mode's host conversion of the group's wire into buf (a CPU
    tensor of block_spec's shape and dtype, pinned for the card)."""
    w = g["wire"]
    b = buf.numpy()
    if mode == "host-convert":
        from ..runtime import iqio

        iqio.convert(w.reshape(-1), "cs16", SCALE,
                     out=(b[0].reshape(-1), b[1].reshape(-1)))
    elif mode == "interleaved":
        np.copyto(b, w)
    else:  # planar int16: a strided copy on the host
        np.copyto(b[0], w[:, 0::2])
        np.copyto(b[1], w[:, 1::2])


def device_input(blk: torch.Tensor, mode: str) -> torch.Tensor:
    """A block where it lies (the card, after its copy) -> complex64
    [slab, T], the input of demodulate."""
    if mode == "host-convert":
        return torch.complex(blk[0], blk[1])
    x = blk.to(torch.float32) * SCALE
    if mode == "interleaved":  # (re, im) pairs along the row: in place
        return torch.view_as_complex(x.view(x.shape[0], -1, 2))
    return torch.complex(x[0], x[1])


def step(g: dict, blk: torch.Tensor, mode: str) -> tuple:
    """The device work of one slab -> (found, status, length) on the
    device."""
    from .. import api

    dem = api.demodulate(device_input(blk, mode), g["cfg"])
    dec = api.decode(dem.symbols, g["cfg"])
    return dem.found, dec.status, dec.length


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return round(int(ln.split()[1]) / 1024, 1)
    return -1.0


def h2d(host: torch.Tensor, samples: int, device) -> dict:
    """The copy of one slab's pinned host block to the card: the median
    of H2D_REPS copies, its GB/s and the Msamples/s (of `samples` complex
    samples a block) the link alone would carry."""
    if device.type != "cuda":
        return {"h2d_GBs_measured": "not measured",
                "h2d_bound_Msamp_s_measured": "not measured"}
    dev = torch.empty_like(host, device=device)
    times = []
    for _ in range(H2D_REPS + 1):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dev.copy_(host, non_blocking=True)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times[1:]))
    nbytes = host.numel() * host.element_size()
    return {"h2d_bytes_per_slab": nbytes,
            "h2d_ms_measured": round(dt * 1e3, 3),
            "h2d_GBs_measured": round(nbytes / dt / 1e9, 2),
            "h2d_bound_Msamp_s_measured": round(samples / dt / 1e6, 1)}


def run(groups: list[dict], mode: str, channels: int, device,
        minutes: float = 0.0) -> tuple[dict, dict]:
    """One end-to-end run over `channels` channels (or `minutes` of wall
    clock) of the groups' slabs in `mode`, then the compute-only and link
    measurements.  -> (the end-to-end record, the compute record); both
    printed."""
    from ..models.decoder import OK
    from ..runtime.staging import Staging

    name, bps = MODES[mode]
    slab = groups[0]["wire"].shape[0]
    n_slabs = -(-channels // slab)
    for g in groups:
        g.update(found=0, ok=0, slabs=0)
    # a slot per queued block, one copied and in flight, one being filled
    staging = Staging(4) if device.type == "cuda" else None
    t_convert = [0.0]

    def host_block(g, stop=None):
        """-> (slot or None, the block) or None when stopped."""
        shape, dtype = block_spec(g, mode)
        if staging is None:
            slot, buf = None, torch.empty(shape, dtype=dtype)
        else:
            got = staging.take(shape, stop, dtype)
            if got is None:
                return None
            slot, buf = got
        t0 = time.perf_counter()
        fill(g, mode, buf)
        t_convert[0] += time.perf_counter() - t0
        return slot, buf

    def dispatch(g, item):
        slot, buf = item
        blk = buf.to(device, non_blocking=slot is not None)
        if slot is not None:
            staging.sent(slot, device)
        return step(g, blk, mode)

    # warm-up outside the timed region: pins every staging buffer, loads the
    # kernels, one slab a group
    if staging is not None:
        staging.reserve(*block_spec(max(groups, key=lambda g: g["T"]), mode))
    for g in groups:
        out = dispatch(g, host_block(g))
        out[0].cpu()
    t_convert[0] = 0.0
    rss_start = rss_mb()

    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()
    deadline_s = minutes * 60.0
    t0 = time.perf_counter()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def ingest():
        try:
            i = 0
            while (time.perf_counter() - t0 < deadline_s if deadline_s
                   else i < n_slabs):
                g = groups[i % len(groups)]
                item = host_block(g, stop)
                if item is None or not put(("blk", g, item)):
                    return
                i += 1
            put(("end", None, None))
        except BaseException as e:  # noqa: BLE001, re-raised below
            put(("err", e, None))

    samples_done = 0
    slab_done_t: list[float] = []

    def settle(pend):
        nonlocal samples_done
        g, (found, status, _length) = pend
        g["found"] += int(found.sum())
        g["ok"] += int((status == OK).sum())
        g["slabs"] += 1
        samples_done += slab * g["T"]
        slab_done_t.append(time.perf_counter() - t0)
        n = len(slab_done_t)
        if minutes and (n % 5 == 0 or n <= 2):
            print(json.dumps({
                "progress_slab": n, "t_s": round(slab_done_t[-1], 1),
                "found": sum(gg["found"] for gg in groups),
                "ok": sum(gg["ok"] for gg in groups),
                "rss_mb": rss_mb(),
            }), flush=True)

    worker = threading.Thread(target=ingest, daemon=True)
    worker.start()
    pending = None
    try:
        while True:
            kind, g, item = q.get()
            if kind == "err":
                raise g
            if kind == "end":
                break
            out = dispatch(g, item)
            if pending is not None:  # depth-1 pipeline: read slab k - 1
                settle(pending)
            pending = (g, out)
        if pending is not None:
            settle(pending)
    finally:
        stop.set()
        worker.join(timeout=60)
    dt = time.perf_counter() - t0
    rss_end = rss_mb()

    g0 = groups[0]
    if not slab_done_t:
        rec = {"bench": "config5_e2e",
               "error": "no slabs ingested before the deadline"}
        print(json.dumps(rec), flush=True)
        return rec, {}
    found_total = sum(g["found"] for g in groups)
    ok_total = sum(g["ok"] for g in groups)
    n_done = sum(g["slabs"] for g in groups)
    rate_e2e = samples_done / dt / 1e6
    per_slab = np.diff(np.concatenate([[0.0], np.asarray(slab_done_t)]))
    half = max(len(per_slab) // 2, 1)
    drift = float(np.median(per_slab[half:]) / np.median(per_slab[:half])) \
        if len(per_slab) >= 4 else 1.0
    label = device_label(device)
    rec = {
        "bench": "config5_e2e",
        "channels": channels, "slab": slab, "slabs": n_done, "T": g0["T"],
        "mode": name,
        "measured_Msamp_s": round(rate_e2e, 1),
        "measured_rt_channels_500kHz": round(rate_e2e * 1e6 / 0.5e6, 1),
        "frames_found": found_total, "frames_decoded_ok": ok_total,
        "of": n_done * slab,
        "wall_s": round(dt, 3),
        "convert_host_s": round(t_convert[0], 3),
        "per_slab_s": {
            "median": round(float(np.median(per_slab)), 4),
            "p95": round(float(np.percentile(per_slab, 95)), 4),
            "max": round(float(per_slab.max()), 4),
            "late_vs_early_drift": round(drift, 3),
        },
        "rss_mb": {"start": rss_start, "end": rss_end},
        "device": label,
        "note": f"measured_* is end to end on {label}",
    }
    if len(groups) > 1:
        rec["groups"] = [
            {"sf": g["sf"], "slabs": g["slabs"], "found": g["found"],
             "ok": g["ok"], "of": g["slabs"] * slab}
            for g in groups
        ]
    print(json.dumps(rec), flush=True)

    # compute only: the first group's slab resident on the device; its
    # pinned block then times the link
    _slot, buf = host_block(g0)
    resident = buf.to(device)
    step(g0, resident, mode)[0].cpu()
    times = []
    for _ in range(REPS):
        tc = time.perf_counter()
        step(g0, resident, mode)[0].cpu()
        times.append(time.perf_counter() - tc)
    del resident
    dt_c = float(np.median(times))
    rate_c = slab * g0["T"] / dt_c / 1e6
    comp = {
        "bench": "config5_e2e_compute",
        "compute_only_Msamp_s_per_slab": round(rate_c, 1),
        "compute_only_ms": {"median": round(dt_c * 1e3, 3),
                            "min": round(min(times) * 1e3, 3),
                            "max": round(max(times) * 1e3, 3)},
        "link_bytes_per_sample": bps,
        **h2d(buf, slab * g0["T"], device),
        "device": label,
        "note": "h2d_* is a measured pinned copy of one slab in this mode",
    }
    print(json.dumps(comp), flush=True)
    return rec, comp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lora_tpu_torch.tools.bench_e2e",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--channels", type=int, default=10240)
    ap.add_argument("--slab", type=int, default=2048)
    ap.add_argument("--host-convert", action="store_true",
                    help="convert on host, ship planar f32")
    ap.add_argument("--interleaved", action="store_true",
                    help="ship raw interleaved wire, deinterleave on device")
    ap.add_argument("--payload", type=int, default=32)
    ap.add_argument("--minutes", type=float, default=0.0,
                    help="sustained mode: keep cycling slabs for this many "
                         "minutes of wall clock; 0 = one pass over "
                         "--channels")
    ap.add_argument("--mixed-sf", action="store_true",
                    help="two config groups (SF10 + SF8), slabs routed "
                         "round robin")
    args = ap.parse_args(argv)
    if args.host_convert and args.interleaved:
        ap.error("--host-convert and --interleaved exclude each other")
    device = pick_device(args.device, "bench_e2e")
    mode = ("host-convert" if args.host_convert
            else "interleaved" if args.interleaved else "planar")
    rng = np.random.default_rng(0)
    groups = [make_group(sf, args.slab, args.payload, rng, device)
              for sf in ((10, 8) if args.mixed_sf else (10,))]
    run(groups, mode, args.channels, device, args.minutes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
