#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

1. Refuses to run without a CUDA device; prints the card's name and power
   limit as nvidia-smi reports them.
2. Builds the kernels (lora_tpu_torch/csrc, nvcc for sm_90a) and prints the
   build time.
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the flagship bank gives it: integer outputs equal (except windows
   whose plain spectrum at the kernel's bin is within 1e-5 relative of the
   peak: float32 FFTs of another order may order a near tie the other
   way), dB values, f_index and fine_total within 1e-3.
4. Runs the slice: a 4096-channel SF10 CR 4/8 bank (32-byte payloads,
   per-channel delay, CFO and phase, AWGN sigma 0.1) through
   demodulate(fused="auto") and decode.  Every frame must decode
   byte-exact, with the frame fields equal to fused="off" on the card;
   then a 4096-channel bank whose CFOs span the whole bin (half-bin
   offsets included) and 512 channels at the reference noise point
   (sigma 4.0) must each give the same frames and payloads on both
   routes.  Every kernel must have launched in the fused="auto" run.
5. Times each stage and the whole demodulate, kernel against plain (CUDA
   events, one warm-up, median of 7 runs).

Prints the kernels' JSON line, then {"ok": true, "device": {...}} last.
Any failure raises and exits non-zero.  Imports no jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 1234
B_FLAGSHIP = 4096
B_NOISY = 512
SIGMA = 0.1
SIGMA_NOISY = 4.0  # the reference's verified operating point (BASELINE.md)
TOL = 1e-3
TIE_RTOL = 1e-5
RUNS = 7


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def flagship_cfg():
    from lora_tpu_torch import LoRaConfig

    cfg = LoRaConfig(sf=10, cr="4/8", ampl=1.0)
    return cfg.replace(mtu=cfg.num_symbols(32) + 4)


def make_bank(api, cfg, B: int, sigma: float, seed: int, dev,
              u_max: float = 0.4):
    """B channels, one frame each at a random delay in [0, 3N), a random
    phase and a CFO of k + u bins (k in -2..2, |u| < u_max), plus AWGN;
    made on the card.  Fractional CFOs near half a bin split every preamble
    peak between two bins, and the coarse search of both packages then
    loses about one frame in a thousand, so the byte-exact bank stays
    clear of them as tests/test_loopback.py does; u_max = 0.5 covers the
    whole bin."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    N = cfg.N
    payload = torch.randint(0, 256, (B, 32), generator=g, device=dev,
                            dtype=torch.int64).to(torch.uint8)
    iq = api.modulate(api.encode(payload, cfg), cfg)
    L = iq.shape[-1]
    T = api.required_samples(cfg)
    delay = torch.randint(0, 3 * N, (B, 1), generator=g, device=dev)
    src = torch.arange(T, device=dev) - delay
    valid = (src >= 0) & (src < L)
    bank = torch.take_along_dim(iq, src.clamp(0, L - 1), dim=1)
    bank = torch.where(valid, bank, 0)
    del iq, src, valid
    cfo = (torch.randint(-2, 3, (B, 1), generator=g, device=dev)
           + (torch.rand((B, 1), generator=g, device=dev) * 2 - 1) * u_max)
    phase = torch.rand((B, 1), generator=g, device=dev) * 6.2831855
    n = torch.arange(T, device=dev, dtype=torch.float32)
    ang = cfo * (6.2831855 / N) * n + phase
    bank = bank * torch.polar(torch.ones_like(ang), ang)
    del ang
    noise = torch.complex(
        torch.randn((B, T), generator=g, device=dev),
        torch.randn((B, T), generator=g, device=dev),
    )
    bank = (bank + sigma * noise).contiguous()
    return bank, payload


class Check:
    """Kernel-vs-plain comparison record of one kernel."""

    def __init__(self, name):
        self.name = name
        self.max_abs_err = 0.0
        self.ties = 0

    def close(self, what, got, want, tol=TOL, mask=None):
        d = (got.float() - want.float()).abs()
        if mask is not None:
            d = d[mask]
        err = float(d.max()) if d.numel() else 0.0
        self.max_abs_err = max(self.max_abs_err, err)
        if not err <= tol:
            raise AssertionError(
                f"{self.name}: {what} differs by {err} > {tol}"
            )

    def equal(self, what, got, want):
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(f"{self.name}: {what} differs in {bad} places")

    def values(self, got, want, spectra):
        """Integer bins equal except near ties: `spectra(idx)` returns the
        plain |X|^2 rows of the mismatching windows (flat indices idx)."""
        import torch

        diff = (got != want).reshape(-1)
        idx = torch.nonzero(diff).reshape(-1)
        if idx.numel():
            m2 = spectra(idx)
            k = got.reshape(-1)[idx].long()
            at_k = torch.gather(m2, 1, k[:, None])[:, 0]
            peak = m2.amax(-1)
            tie = (peak - at_k) <= TIE_RTOL * peak
            if not bool(tie.all()):
                raise AssertionError(
                    f"{self.name}: {int((~tie).sum())} bins differ beyond "
                    "a near tie"
                )
            self.ties += int(idx.numel())
        return ~diff.reshape(got.shape)


def check_detect(chk, det_ops, cuda_detect, x, down, fe, want_findex):
    """Kernel A vs plain on windows x [..., N]."""
    import torch

    k = cuda_detect.dechirp_detect(x, down, fe, want_f_index=want_findex)
    p = det_ops.dechirp_detect(x, down, fe, want_f_index=want_findex)
    N = x.shape[-1]

    def spectra(idx):
        xf = x.reshape(-1, N)[idx]
        ff = None if fe is None else torch.broadcast_to(
            fe, x.shape[:-1]).reshape(-1)[idx][:, None]
        return det_ops.dechirp_detect(xf, down, ff, want_mag2=True).mag2

    ok = chk.values(k.value, p.value, spectra)
    chk.close("power", k.power, p.power, mask=ok)
    chk.close("noise", k.noise, p.noise, mask=ok)
    if want_findex:
        chk.close("f_index", k.f_index, p.f_index, mask=ok)


def timed(fn, sync):
    """Median ms of RUNS calls after one warm-up, by CUDA events."""
    import torch

    fn()
    sync()
    times = []
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on the card")
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from lora_tpu_torch import api
    from lora_tpu_torch.models import demodulator as dm
    from lora_tpu_torch.ops import _cuda, cuda_demod, cuda_detect
    from lora_tpu_torch.ops import detect as det_ops

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- 1. build ------------------------------------------------------
    t = time.perf_counter()
    _cuda.library()
    print(f"build: {time.perf_counter() - t:.1f} s "
          f"({_cuda.library_path().name})", flush=True)

    cfg = flagship_cfg()
    N, mtu = cfg.N, cfg.mtu
    bank, payload = make_bank(api, cfg, B_FLAGSHIP, SIGMA, SEED, dev)
    B, T = bank.shape
    W = T // N
    win = bank[:, : W * N].reshape(B, W, N)
    print(f"bank: B={B} T={T} ({W} windows of N={N}), mtu={mtu}, "
          f"{bank.numel() * 8 / 1e9:.2f} GB complex64", flush=True)

    # ---- 2. kernels vs plain at the flagship shapes -----------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    chk_a = Check("detect")
    check_detect(chk_a, det_ops, cuda_detect, win, False, None, False)
    for n_win in (1024, 128):
        rnd = torch.complex(
            torch.randn((65536, n_win), generator=gen, device=dev),
            torch.randn((65536, n_win), generator=gen, device=dev),
        )
        fe = torch.rand(65536, generator=gen, device=dev) - 0.5
        for down in ((False, True) if n_win == 1024 else (False,)):
            check_detect(chk_a, det_ops, cuda_detect, rnd, down, fe, True)
    del rnd
    sync()
    print(f"kernel A parity: ok, {chk_a.ties} near-tie windows, "
          f"max |err| {chk_a.max_abs_err:.3g}", flush=True)

    v, snr0, pwr = dm._coarse_detect(bank, cfg, False)
    t_cand, t0, found_pre = dm._align_frame(v, snr0, pwr, cfg, T)
    chk_b = Check("track")
    kb = cuda_demod.track(bank, t0, cfg.sync, cfg.thresh, N)
    pb = cuda_demod.track_plain(bank, t0, cfg.sync, cfg.thresh, N)
    for f in ("synced", "k_sync", "freq_error"):
        chk_b.equal(f, kb[f], pb[f])
    for f in ("fine_total", "power", "snr"):
        chk_b.close(f, kb[f], pb[f])
    sync()
    print(f"kernel B parity: ok, max |err| {chk_b.max_abs_err:.3g}",
          flush=True)

    head, fine_total = dm._head(pb, cfg, t0, t_cand, found_pre, T)
    ds = head.consumed
    chk_c = Check("payload")
    kc = cuda_demod.payload_detect(bank, ds, fine_total, mtu, N)
    pc = cuda_demod.payload_detect_plain(bank, ds, fine_total, mtu, N)

    def payload_spectra(idx):
        b = idx // mtu
        w = idx % mtu
        start = ds.long()[b] + w * N
        xw = torch.take_along_dim(
            bank[b], start[:, None] + torch.arange(N, device=dev), dim=1)
        return det_ops.dechirp_detect(xw, ferr=fine_total[b][:, None],
                                      want_mag2=True).mag2

    ok = chk_c.values(kc[0], pc[0], payload_spectra)
    chk_c.close("power", kc[1], pc[1], mask=ok)
    chk_c.close("noise", kc[2], pc[2], mask=ok)
    sync()
    print(f"kernel C parity: ok, {chk_c.ties} near-tie windows, "
          f"max |err| {chk_c.max_abs_err:.3g}", flush=True)

    # ---- 3. the slice through the kernels --------------------------------
    wrappers = {
        "detect": cuda_detect.dechirp_detect,
        "track": cuda_demod.track,
        "payload": cuda_demod.payload_detect,
    }
    for w in wrappers.values():
        w.launches = 0
    dem = api.demodulate(bank, cfg, fused="auto")
    dec = api.decode(dem.symbols, cfg)
    sync()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"launches in the fused='auto' run: {launches}", flush=True)
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the path")
    lost = (~dem.found).nonzero().reshape(-1).tolist()
    if lost:
        raise AssertionError(f"{len(lost)} of {B} frames not found: {lost}")
    got = api.extract_payloads(dec)
    want = [bytes(p) for p in payload.cpu().numpy().tolist()]
    bad = [i for i in range(B) if got[i] != want[i]]
    if bad:
        raise AssertionError(f"{len(bad)} of {B} payloads not byte-exact: "
                             f"{bad}")
    for f in ("symbols", "count", "power", "snr", "fine_freq"):
        d = getattr(dem, f)
        if d.dtype.is_floating_point and not bool(torch.isfinite(d).all()):
            raise AssertionError(f"non-finite {f}")
    ref = api.demodulate(bank, cfg, fused="off")
    for f in ("found", "symbols", "t_sync", "consumed", "freq_error"):
        if not torch.equal(getattr(dem, f), getattr(ref, f)):
            raise AssertionError(f"fused='auto' and 'off' differ in {f}")
    print(f"slice: {B}/{B} frames found and byte-exact; found, symbols, "
          "t_sync, consumed, freq_error equal to fused='off'", flush=True)
    del ref, dec

    for what, n_ch, sigma, seed, u_max in (
        ("whole-bin CFO", B_FLAGSHIP, SIGMA, SEED + 3, 0.5),
        ("reference noise point", B_NOISY, SIGMA_NOISY, SEED + 2, 0.4),
    ):
        other, opay = make_bank(api, cfg, n_ch, sigma, seed, dev, u_max)
        dems = [api.demodulate(other, cfg, fused=r) for r in ("auto", "off")]
        for f in ("found", "symbols", "t_sync", "consumed", "freq_error"):
            if not torch.equal(getattr(dems[0], f), getattr(dems[1], f)):
                raise AssertionError(f"{what}: the routes differ in {f}")
        outs = [api.extract_payloads(api.decode(d.symbols, cfg))
                for d in dems]
        if outs[0] != outs[1]:
            raise AssertionError(f"{what}: the routes' payloads differ")
        owant = [bytes(p) for p in opay.cpu().numpy().tolist()]
        good = sum(g == w for g, w in zip(outs[0], owant))
        print(f"{what} (sigma={sigma}, |u| < {u_max}): B={n_ch}, both routes "
              f"equal, {int(dems[0].found.sum())} found, {good}/{n_ch} "
              "payloads byte-exact", flush=True)
        del other, dems

    # ---- 4. times ---------------------------------------------------------
    stages = {
        "detect": (
            lambda: cuda_detect.dechirp_detect(win, want_f_index=False),
            lambda: det_ops.dechirp_detect(win, want_f_index=False),
        ),
        "track": (
            lambda: cuda_demod.track(bank, t0, cfg.sync, cfg.thresh, N),
            lambda: cuda_demod.track_plain(bank, t0, cfg.sync, cfg.thresh, N),
        ),
        "payload": (
            lambda: cuda_demod.payload_detect(bank, ds, fine_total, mtu, N),
            lambda: cuda_demod.payload_detect_plain(bank, ds, fine_total,
                                                    mtu, N),
        ),
    }
    ms = {}
    for name, (kern, plain) in stages.items():
        # plain, kernel, kernel, plain: the two orders cancel drift
        p1 = timed(plain, sync)
        k1 = timed(kern, sync)
        k2 = timed(kern, sync)
        p2 = timed(plain, sync)
        ms[name] = (min(k1, k2), min(p1, p2))
        print(f"time {name}: kernel {ms[name][0]:.3f} ms, plain "
              f"{ms[name][1]:.3f} ms (B={B}, N={N}) [{card}]", flush=True)
    e2e = {}
    for route in ("off", "auto", "auto", "off"):
        t_ms = timed(lambda: api.demodulate(bank, cfg, fused=route), sync)
        e2e[route] = min(e2e.get(route, t_ms), t_ms)
    for route in ("auto", "off"):
        rate = B * T / (e2e[route] * 1e-3) / 1e6
        print(f"time demodulate fused={route!r}: {e2e[route]:.3f} ms, "
              f"{rate:.1f} Msamples/s (B={B}, T={T}) [{card}]", flush=True)

    sources = {
        "detect": ("lora_tpu_torch/csrc/detect.cu",
                   "lora_tpu/ops/pallas_detect.py:387"),
        "track": ("lora_tpu_torch/csrc/track.cu",
                  "lora_tpu/ops/pallas_demod.py:1059, "
                  "lora_tpu/ops/pallas_demod.py:1169"),
        "payload": ("lora_tpu_torch/csrc/payload.cu",
                    "lora_tpu/ops/pallas_demod.py:465, "
                    "lora_tpu/ops/pallas_demod.py:792, "
                    "lora_tpu/ops/pallas_demod.py:627"),
    }
    checks = {"detect": chk_a, "track": chk_b, "payload": chk_c}
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": launches[name],
            "max_abs_err": checks[name].max_abs_err,
            "ms": ms[name][0],
            "plain_ms": ms[name][1],
        }
        for name in ("detect", "track", "payload")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
