"""The radio's parameters and the frame's geometry, for the plain reference.

A frozen copy of lora_tpu_torch/config.py (LoRaConfig: the fields, the
codeword and symbol counts, the frame length) and of the demodulator's
buffer geometry (lora_tpu_torch/models/demodulator.py `required_samples`,
lora_tpu_torch/ops/tables.py `payload_rows`).  The benchmark's yardstick
lives here so that a change to the program cannot move it; it imports
nothing of the program.
"""

from __future__ import annotations

import dataclasses

CODING_RATES = {"4/4": 0, "4/5": 1, "4/6": 2, "4/7": 3, "4/8": 4}
HEADER_RDD = 4
N_HEADER_SYMBOLS = HEADER_RDD + 4
N_HEADER_CODEWORDS = 5

N_SCAN = 13                  # aligned windows scanned for the sync word
N_TRACK_WIN = N_SCAN + 4     # scan + 2 downchirps + quarter margin
TRACK_ROWS = N_TRACK_WIN + 1
_FLAT_MAX = 1 << 18


@dataclasses.dataclass(frozen=True)
class Radio:
    """The PHY settings the benchmark's configurations state (the same
    fields and defaults as the program's LoRaConfig)."""

    sf: int = 10
    cr: str = "4/8"
    ppm: int = 0
    explicit_header: bool = True
    crc: bool = True
    whitening: bool = True
    sync: int = 0x12
    ovs: int = 1
    padding: int = 1
    preamble_symbols: int = 10
    ampl: float = 0.3
    thresh: float = -30.0
    mtu: int = 256
    hdr: bool = False
    data_length: int = 8
    crc_check: bool = False
    interleaving: bool = True
    error_check: bool = True

    @property
    def rdd(self) -> int:
        return CODING_RATES[self.cr]

    @property
    def N(self) -> int:
        return 1 << self.sf

    @property
    def NN(self) -> int:
        return self.N * self.ovs

    @property
    def PPM(self) -> int:
        return self.sf if self.ppm == 0 else self.ppm

    def num_codewords(self, payload_len: int) -> int:
        nbytes = payload_len + (2 if self.crc else 0)
        raw = nbytes * 2 + (N_HEADER_CODEWORDS if self.explicit_header else 0)
        return -(-raw // self.PPM) * self.PPM

    def num_symbols(self, payload_len: int) -> int:
        ncw = self.num_codewords(payload_len)
        return N_HEADER_SYMBOLS + (ncw // self.PPM - 1) * (4 + self.rdd)

    def head_samples(self) -> int:
        """Preamble, sync word, 2.25 downchirps."""
        return self.NN * (self.preamble_symbols + 4) + self.NN // 4

    def frame_samples(self, num_symbols: int) -> int:
        return self.head_samples() + self.NN * (num_symbols + self.padding)

    def replace(self, **kw) -> "Radio":
        return dataclasses.replace(self, **kw)


def payload_rows(N: int, mtu: int) -> int:
    """Aligned rows each channel's payload stage spans (>= mtu + 1)."""
    rp = 8 * (mtu // 8 + 1)
    if rp * N <= _FLAT_MAX:
        return rp
    cap = max(8, min(128, (1 << 19) // (N * 4)))
    m = mtu // 8 + 1
    best = max(d for d in range(1, m + 1) if m % d == 0 and 8 * d <= cap)
    return 8 * m if m // best == 1 else 8 * m + 8


def required_samples(cfg: Radio, search_symbols: int = 4) -> int:
    """The demodulator's buffer length (a multiple of N)."""
    N = cfg.N
    rp = payload_rows(N, cfg.mtu)
    head = cfg.preamble_symbols + 2 + 2 + 1
    w = search_symbols + head + max(cfg.mtu + 1, rp) + 1
    w += (-(w - rp)) % 8
    return w * N


def radio(fields: dict) -> Radio:
    """A Radio from a configuration file's `radio` group: the fields of
    LoRaConfig, and `payload_bytes` with `mtu_extra`, which set mtu to the
    frame's symbol count plus that many."""
    f = dict(fields)
    payload = f.pop("payload_bytes")
    extra = f.pop("mtu_extra")
    cfg = Radio(**f)
    return cfg.replace(mtu=cfg.num_symbols(payload) + extra)
