"""The closed-loop generator of wideband blocks whose slots are spaced wider
than the LoRa bandwidth (LoRaWAN US902-928: 125-kHz uplinks 200 kHz
apart), one caller, one call at a time.

A call hands the program a [streams, M*K] wideband block with a frame on
every slot: `api.channelized_demodulate(block, K, slot_ratio=r)` (the
filterbank into K slots of M samples, each resampled to the LoRa rate,
M / r samples, then the demodulator), then `api.decode(symbols)`, then
every field read back as phybench/generators/bank.py reads it.  The loop,
the read-back, the window, the verdict and the numbers are bank.py's own
(its `run`, with this module's banks in the place of its `Banks`), so the
cell is measured as the other cells are.

The blocks: frames of the frozen transmitter (phybench/reference/tx.py) at
the LoRa rate, impaired as bank.py's wideband traffic (inputs.impair),
interpolated to the slot rate by the frozen resampler
(phybench/reference/resample.py, ratio 1/r), merged by the frozen
synthesis bank and given AWGN at the wideband rate.  The reference of a
block: the frozen channelizer, the frozen resampler, the plain receiver.

    python3 -m phybench.generators.spaced --workload <name> --seeds ... \
        --control-seeds ...

is phybench.calibrate with these banks (its control builds bank.Banks).
"""

from __future__ import annotations

import contextlib
import sys
from fractions import Fraction

import numpy as np
import torch

from .. import inputs
from ..reference import channelizer as rch
from ..reference import resample as rres
from ..reference import tx
from ..reference.lora import required_samples
from . import bank


def ratio_of(conf: dict) -> Fraction:
    """The configuration's slot samples per LoRa sample."""
    return Fraction(conf["slot_ratio"])


def wideband(cfg, S: int, K: int, taps: int, ratio: Fraction, nbytes: int,
             imp: dict, g, dev):
    """S wideband streams at K slots of `ratio` times the LoRa rate, a
    frame on every slot.  -> (wide complex64 [S, M*K] on the card, M =
    required_samples * ratio; payloads uint8 [S, K, nbytes] on the
    host)."""
    Mp = required_samples(cfg)
    M = Mp * ratio
    if M.denominator != 1:
        raise ValueError(f"{Mp} LoRa samples are no whole number of slot "
                         f"samples at {ratio}")
    M = int(M)
    payload = inputs.payloads(S * K, nbytes, g, dev)
    out = torch.empty((S, M * K), dtype=torch.complex64, device=dev)
    step = max(1, inputs.ROWS // K)
    for s in range(0, S, step):
        n = min(step, S - s)
        f = inputs.impair(tx.frames(payload[s * K : (s + n) * K], cfg), Mp,
                          cfg.N, g, imp["max_delay_symbols"] * cfg.N,
                          imp["cfo_int"], imp["cfo_frac"])
        f = rres.resample(f, float(1 / ratio), out_len=M)
        w = rch.synthesize(f.reshape(n, K, M), taps)
        del f
        out[s : s + n] = w + inputs.awgn(w.shape, imp["sigma"], g, dev)
        del w
    return out, payload.reshape(S, K, nbytes).cpu().numpy()


class Banks(bank.Banks):
    """A cell's blocks made from the seed, what was sent on them, and the
    program's call (bank.Banks' fields, for its loop)."""

    def __init__(self, r, fused: str = None):
        from lora_tpu_torch import api

        from ..harness import program_config

        cell, dev = r.cell, r.dev
        self.cfg = cfg = cell.radio()
        self.pcfg = pcfg = program_config(cfg)
        self.conf = conf = cell.config
        self.entry = cell.traffic["entry"]
        if self.entry != "channelized_demodulate":
            raise ValueError(f"spaced generator: unknown entry {self.entry!r}")
        fused = fused or "auto"
        self.nbytes = nbytes = conf["radio"]["payload_bytes"]
        S, K, L = conf["streams"], conf["K"], conf["taps_per_phase"]
        self.ratio = ratio = ratio_of(conf)
        g = inputs.generator(r.seed, dev)
        self.banks, self.sent = [], []
        for _ in range(cell.traffic["banks"]):
            x, p = wideband(cfg, S, K, L, ratio, nbytes,
                            cell.traffic["impair"], g, dev)
            self.banks.append(x)
            self.sent.append(p.reshape(-1, nbytes))
        Mp = required_samples(cfg)
        M = x.shape[-1] // K
        self.samples = S * M * K
        self.shapes = {"detect": (S * K, Mp, cfg.N),
                       "channelize": (S, M * K, K, L),
                       "resample": (S * K, M, Mp,
                                    rres.taps_for(float(ratio)))}
        self.call = lambda x: api.channelized_demodulate(
            x, K, pcfg, L, fused=fused, slot_ratio=ratio)[0]
        self.decode = lambda s: api.decode(s, pcfg)
        self.readback = None

    def reference(self, i: int, bf16: bool = False) -> dict:
        return reference(self.banks[i], self.cfg, self.conf, bf16)


def reference(x, cfg, conf: dict, bf16: bool = False) -> dict:
    """The plain reference's demod and decode fields of one wideband block,
    on x's device, in blocks of bank.REF_ROWS channels: the frozen
    channelizer, the frozen resampler, the plain receiver."""
    K, L = conf["K"], conf["taps_per_phase"]
    ratio = ratio_of(conf)
    Mp = required_samples(cfg)
    step = max(1, bank.REF_ROWS // K)
    parts = []
    for s in range(0, x.shape[0], step):
        y = rch.channelize(x[s : s + step], K, L)
        y = rres.resample(y.reshape(-1, y.shape[-1]), float(ratio),
                          out_len=Mp)
        parts.append(bank.reference(y, cfg, "demodulate", conf, bf16))
        del y
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return {k: v.reshape(x.shape[0], K, *v.shape[1:])
            for k, v in out.items()}


@contextlib.contextmanager
def in_place_of_bank():
    """bank.run and calibrate.control_numbers build bank.Banks: inside,
    they build this module's."""
    was = bank.Banks
    bank.Banks = Banks
    try:
        yield
    finally:
        bank.Banks = was


def run(r) -> dict:
    with in_place_of_bank():
        return bank.run(r)


def main(argv=None) -> int:
    from .. import calibrate

    with in_place_of_bank():
        return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
