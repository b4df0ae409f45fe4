"""Head-to-head RX sensitivity on identical noisy banks (port of
tools/bench_sensitivity.py).

    python -m lora_tpu_torch.tools.bench_sensitivity [--packets 40]
        [--sf 7 10] [--cr 4/8] [--noise ...] [--rotate R] [--soft]
        [--seed 2026] [--out FILE] [--device cpu]

Every point builds one noisy waveform bank exactly as lora_tpu's tool does
(payloads with a unique first byte, delays in [0, 2N), the port's TX, AWGN
from a numpy generator keyed (seed, sf, int(noise * 1000)), the same draw
order) and demodulates and decodes it on the device (the card unless
--device names another).  A frame counts as recovered iff its payload
decodes byte-exactly.

The reference FSM (tools/gen_demod_golden, the reference's LoRaDemod.cpp
compiled against the Pothos stub) runs on the same bank only where that
binary exists; it is built from the reference sources, which this
repository does not carry.  Otherwise each row takes the reference's and
lora_tpu's counts from the committed row at the same (sf, cr, noise_ampl,
rotate, n) of docs/sensitivity_vs_reference.json, which lora_tpu measured
on the identical banks: recovered_ref, fer_ref, and lora_tpu's
recovered_ours / recovered_soft as recovered_jax / recovered_jax_soft.
`ref_source` says which ("oracle" or that file); a point with neither has
no recovered_ref and says so.

One JSON row per point, with lora_tpu's keys and the pairing's:
  {"sf", "cr", "noise_ampl", "snr_db", "n", "recovered_ours",
   "recovered_ref", "fer_ours", "fer_ref", ["rotate"], ["recovered_soft",
   "fer_soft"], "recovered_jax", ["recovered_jax_soft"], "ref_source",
   "device"}
written as a list to --out (build/lora_tpu_torch/sensitivity/ by default;
never docs/).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

from . import DOCS, OUT_DIR, REPO, device_label, out_path, pick_device

ORACLE = REPO / "tools" / "gen_demod_golden"
COMMITTED = DOCS / "sensitivity_vs_reference.json"
DEFAULT_OUT = OUT_DIR / "sensitivity" / "sensitivity_vs_reference.json"
SEED = 2026

# noise grids bracketing each SF's FER transition (tools/bench_sensitivity.py)
GRIDS = {
    7: (1.4, 1.7, 2.0, 2.3, 2.6),
    8: (1.8, 2.2, 2.6, 3.0, 3.4),
    10: (4.0, 4.8, 5.6, 6.4, 7.2),
    12: (8.0, 9.6, 11.2, 12.8, 14.4),
}
PAYLOAD_LEN = 16


@dataclasses.dataclass
class Bank:
    """One point's noisy bank on the host: payloads uint8 [P, 16], delays
    [P], re and im float32 [P, T]."""

    payloads: np.ndarray
    delays: np.ndarray
    re: np.ndarray
    im: np.ndarray


def point_cfg(sf: int, cr: str):
    """The tool's config: CR cr, amplitude 1, mtu for a 16-byte payload plus
    4 symbols."""
    from ..config import LoRaConfig

    cfg = LoRaConfig(sf=sf, cr=cr, ampl=1.0)
    return cfg.replace(mtu=cfg.num_symbols(PAYLOAD_LEN) + 4)


def draw(cfg, noise: float, P: int, seed: int = SEED):
    """The point's generator, keyed as lora_tpu keys it, after its first
    two draws.  -> (rng, payloads uint8 [P, 16] with a unique first byte,
    delays [P] in [0, 2N))."""
    rng = np.random.default_rng((seed, cfg.sf, int(noise * 1000)))
    payloads = rng.integers(0, 256, (P, PAYLOAD_LEN), np.uint8)
    payloads[:, 0] = np.arange(P)  # unique per frame
    delays = rng.integers(0, 2 * cfg.N, P)
    return rng, payloads, delays


def noisy(rng, cre: np.ndarray, cim: np.ndarray, delays: np.ndarray, T: int,
          noise: float, rotate: float = 0.0) -> tuple:
    """The clean frames (float32 [P, L] planes) placed at their delays in
    [P, T] buffers, plus the generator's AWGN, then the static rotation.
    -> (re, im) float32 [P, T]."""
    P, L = cre.shape
    bank_re = np.zeros((P, T), np.float32)
    bank_im = np.zeros((P, T), np.float32)
    for p in range(P):
        d = int(delays[p])
        k = min(L, T - d)
        bank_re[p, d : d + k] = cre[p, :k]
        bank_im[p, d : d + k] = cim[p, :k]
    bank_re += noise * rng.standard_normal((P, T)).astype(np.float32)
    bank_im += noise * rng.standard_normal((P, T)).astype(np.float32)
    if rotate:
        # a static channel rotation of the shared bank
        c, s = np.cos(rotate), np.sin(rotate)
        bank_re, bank_im = (
            (c * bank_re - s * bank_im).astype(np.float32),
            (s * bank_re + c * bank_im).astype(np.float32),
        )
    return bank_re, bank_im


def make_bank(cfg, noise: float, P: int, seed: int = SEED,
              rotate: float = 0.0, device=None) -> Bank:
    """lora_tpu's bank (tools/bench_sensitivity.py:120-155), draw for draw;
    the clean frames are the port's TX on `device`."""
    from .. import api

    rng, payloads, delays = draw(cfg, noise, P, seed)
    clean = api.modulate(api.encode(payloads, cfg, device=device),
                         cfg).cpu().numpy()
    re, im = noisy(rng, clean.real, clean.imag, delays,
                   api.required_samples(cfg), noise, rotate)
    return Bank(payloads, delays, re, im)


def recovered(found: np.ndarray, got: list, payloads: np.ndarray
              ) -> np.ndarray:
    """bool [P]: frame i found and its payload byte-exact."""
    return np.array([bool(found[i]) and got[i] == bytes(payloads[i].tolist())
                     for i in range(len(got))], bool)


def run_oracle(x: np.ndarray, cfg, tmp: pathlib.Path) -> dict:
    """Drive the compiled reference demod FSM over complex64 samples."""
    buf = np.empty(2 * x.size, np.float32)
    buf[0::2] = x.real
    buf[1::2] = x.imag
    f = tmp / "sens_in.cf32"
    f.write_bytes(buf.tobytes())
    out = subprocess.run(
        [str(ORACLE), str(f), str(cfg.sf), hex(cfg.sync), str(cfg.thresh),
         str(cfg.mtu)],
        capture_output=True, text=True, check=True,
    )
    return json.loads(out.stdout)


def oracle_recovered(bank: Bank, cfg, device) -> int:
    """Frames the reference FSM recovers from the bank as one continuous
    stream, its symbol packets through the port's decoder."""
    from .. import api

    sent = {bytes(p.tolist()) for p in bank.payloads}
    stream = (bank.re + 1j * bank.im).astype(np.complex64).reshape(-1)
    with tempfile.TemporaryDirectory() as tmp:
        ref = run_oracle(stream, cfg, pathlib.Path(tmp))
    ok, seen = 0, set()
    for pkt in ref["packets"]:
        sym = np.zeros(cfg.mtu, np.int32)
        k = min(len(pkt), cfg.mtu)
        sym[:k] = np.asarray(pkt[:k], np.int32)
        pl = api.extract_payloads(api.decode(sym[None], cfg,
                                             device=device))[0]
        if pl is not None and pl in sent and pl not in seen:
            seen.add(pl)
            ok += 1
    return ok


def committed_rows(path=COMMITTED) -> list[dict]:
    p = pathlib.Path(path)
    return json.loads(p.read_text()) if p.exists() else []


def committed_row(rows: list[dict], sf: int, cr: str, noise: float,
                  rotate: float, n: int) -> dict | None:
    """The committed row at this point (rotate as lora_tpu rounds it)."""
    rot = round(rotate, 4) if rotate else 0
    for r in rows:
        if (r["sf"], r["cr"], r["noise_ampl"], r.get("rotate", 0),
                r["n"]) == (sf, cr, noise, rot, n):
            return r
    return None


def point(cfg, noise: float, P: int, seed: int = SEED, rotate: float = 0.0,
          soft: bool = False, fused: str = "auto", device=None,
          bank: Bank | None = None):
    """One operating point on one bank (built here unless given, so that
    one bank can go to both routes).  -> (row, per_frame): per_frame holds
    each frame's found, symbols, hard-recovered and, with soft,
    soft-recovered flags (numpy, [P] and [P, mtu])."""
    from .. import api
    from ..ops import cplx

    device = pick_device(device, "bench_sensitivity")
    if bank is None:
        bank = make_bank(cfg, noise, P, seed, rotate, device)
    x = cplx.from_planar(bank.re, bank.im, device)
    dem = api.demodulate(x, cfg, spectra=soft, fused=fused)
    found = dem.found.cpu().numpy()
    hard = recovered(found, api.extract_payloads(
        api.decode(dem.symbols, cfg)), bank.payloads)
    per_frame = {"found": found, "symbols": dem.symbols.cpu().numpy(),
                 "hard": hard, "soft": None}
    if soft:
        per_frame["soft"] = recovered(found, api.extract_payloads(
            api.decode_soft(dem.fft_mag2, cfg)), bank.payloads)
    del x, dem
    ours = int(hard.sum())
    row = {
        "sf": cfg.sf, "cr": cfg.cr, "noise_ampl": noise,
        "snr_db": round(float(-10 * np.log10(2 * noise * noise)), 2),
        "n": P, "recovered_ours": ours,
        "fer_ours": round(1 - ours / P, 4),
    }
    if rotate:
        row["rotate"] = round(rotate, 4)
    if soft:
        s = int(per_frame["soft"].sum())
        row["recovered_soft"] = s
        row["fer_soft"] = round(1 - s / P, 4)
    old = committed_row(committed_rows(), cfg.sf, cfg.cr, noise, rotate, P)
    if ORACLE.exists():
        ref = oracle_recovered(bank, cfg, device)
        row.update(recovered_ref=ref, fer_ref=round(1 - ref / P, 4),
                   ref_source="oracle")
    elif old is not None:
        row.update(recovered_ref=old["recovered_ref"],
                   fer_ref=old["fer_ref"],
                   ref_source=str(COMMITTED.relative_to(REPO)))
    else:
        row["ref_source"] = ("none: no tools/gen_demod_golden and no "
                             "committed row at this point")
    if old is not None:
        row["recovered_jax"] = old["recovered_ours"]
        if "recovered_soft" in old:
            row["recovered_jax_soft"] = old["recovered_soft"]
    row["device"] = device_label(device)
    return row, per_frame


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lora_tpu_torch.tools.bench_sensitivity",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=int, nargs="+", default=[7, 10])
    ap.add_argument("--cr", nargs="+", default=["4/8"],
                    help="coding rates to sweep (paired per (sf, cr))")
    ap.add_argument("--rotate", type=float, default=0.0,
                    help="static channel phase rotation in radians applied "
                         "to the shared noisy banks (pi/1.2345 in the "
                         "reference's lora_simulation.pth)")
    ap.add_argument("--packets", type=int, default=40)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--noise", type=float, nargs="+", default=None,
                    help="override the per-SF noise grid")
    ap.add_argument("--soft", action="store_true",
                    help="also run the soft-decision decoder "
                         "(api.decode_soft) on the same banks")
    args = ap.parse_args(argv)
    device = pick_device(args.device, "bench_sensitivity")
    out = out_path(args.out)
    rows = []
    for sf in args.sf:
        for cr in args.cr:
            cfg = point_cfg(sf, cr)
            grid = args.noise or GRIDS.get(sf)
            if grid is None:
                raise SystemExit(f"no noise grid for SF{sf}; pass --noise")
            for noise in grid:
                row, _ = point(cfg, noise, args.packets, args.seed,
                               args.rotate, args.soft, device=device)
                rows.append(row)
                print(json.dumps(row), flush=True)
    out.write_text(json.dumps(rows, indent=1))
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
