"""Configuration of the PHY chain: the port's own copy of
`lora_tpu/config.py` (the port imports nothing of the JAX package), with
the same fields, defaults, checks and derived quantities;
`tests/test_torch_config.py` holds the two classes against each other.

The reference exposes block parameters through Pothos reflected setters
(LoRaEncoder.cpp:84-130, LoRaDecoder.cpp:111-183, LoRaMod.cpp:65-102,
LoRaDemod.cpp:76-137).  Here the whole PHY is configured by one frozen,
hashable dataclass, which the port's functions only read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

CODING_RATES = {"4/4": 0, "4/5": 1, "4/6": 2, "4/7": 3, "4/8": 4}

HEADER_RDD = 4
N_HEADER_SYMBOLS = HEADER_RDD + 4
N_HEADER_CODEWORDS = 5


@dataclasses.dataclass(frozen=True)
class LoRaConfig:
    """Static configuration of the LoRa PHY chain.

    Parameters mirror the reference blocks' setters:
      sf          spreading factor, symbol = 2**sf chips       (LoRaMod.cpp:29)
      cr          coding rate "4/4".."4/8"                      (LoRaEncoder.cpp:109)
      ppm         symbol-set size; 0 => ppm == sf               (LoRaEncoder.cpp:104)
      explicit_header / crc / whitening                         (LoRaEncoder.cpp:119-130)
      sync        2-nibble sync word                            (LoRaMod.cpp:79)
      ovs         TX oversampling ratio in [1, 256]             (LoRaMod.cpp:94)
      padding     TX zero padding, symbols                      (LoRaMod.cpp:84)
      ampl        TX amplitude                                  (LoRaMod.cpp:89)
      thresh      demod squelch threshold, dB SNR               (LoRaDemod.cpp:129)
      mtu         demod max symbols per frame                   (LoRaDemod.cpp:134)
      hdr / data_length / crc_check / interleaving / error_check
                  decoder options                               (LoRaDecoder.cpp:153-183)
    """

    sf: int = 10
    cr: str = "4/8"
    ppm: int = 0
    explicit_header: bool = True
    crc: bool = True
    whitening: bool = True
    sync: int = 0x12
    ovs: int = 1
    padding: int = 1
    # TX preamble upchirps.  The reference modulator hardcodes 10
    # (LoRaMod.cpp:135); real LoRa radios configure 6..65535, and the
    # demodulator's run-end alignment search locks whatever the length.
    preamble_symbols: int = 10
    ampl: float = 0.3
    thresh: float = -30.0
    mtu: int = 256
    hdr: bool = False
    data_length: int = 8
    crc_check: bool = False
    interleaving: bool = True
    error_check: bool = True

    def __post_init__(self):
        if not (6 <= self.sf <= 12):
            raise ValueError(f"invalid spreading factor {self.sf}")
        if self.cr not in CODING_RATES:
            raise ValueError(f"unknown coding rate {self.cr!r}")
        if not (1 <= self.ovs <= 256):
            raise ValueError(f"invalid oversampling ratio {self.ovs}")
        if self.PPM > self.sf:
            raise ValueError("failed check: PPM <= SF")
        if self.preamble_symbols < 6:
            raise ValueError("preamble must be at least 6 symbols")

    # -- derived static quantities ------------------------------------------
    @property
    def rdd(self) -> int:
        return CODING_RATES[self.cr]

    @property
    def N(self) -> int:
        """Chips (samples at 1x) per symbol."""
        return 1 << self.sf

    @property
    def NN(self) -> int:
        """Samples per symbol at the TX oversampling ratio."""
        return self.N * self.ovs

    @property
    def PPM(self) -> int:
        return self.sf if self.ppm == 0 else self.ppm

    def num_codewords(self, payload_len: int) -> int:
        """Whitened/FEC codeword count for a payload of `payload_len` bytes
        (LoRaEncoder.cpp:171-175)."""
        nbytes = payload_len + (2 if self.crc else 0)
        raw = nbytes * 2 + (N_HEADER_CODEWORDS if self.explicit_header else 0)
        ppm = self.PPM
        return ((raw + ppm - 1) // ppm) * ppm

    def num_symbols(self, payload_len: int) -> int:
        """Modulation symbol count (LoRaEncoder.cpp:176): the first
        interleaver block is always rate 4/8 => 8 symbols."""
        ncw = self.num_codewords(payload_len)
        return N_HEADER_SYMBOLS + (ncw // self.PPM - 1) * (4 + self.rdd)

    def frame_samples(self, num_symbols: int) -> int:
        """TX samples for a frame: preamble + 2 sync + 2 down + 1/4 down
        + data + padding (LoRaMod frame FSM, LoRaMod.cpp:140-229)."""
        NN = self.NN
        head = NN * (self.preamble_symbols + 2 + 2) + NN // 4
        return head + NN * num_symbols + NN * self.padding

    def replace(self, **kw) -> "LoRaConfig":
        return dataclasses.replace(self, **kw)
