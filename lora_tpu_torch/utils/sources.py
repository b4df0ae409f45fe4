"""Test packet sources (a copy of lora_tpu/utils/sources.py, which imports
no jax; tests/test_torch_cli.py holds the two against each other).

Ports of the reference's generator blocks (TestGen.cpp:18-52,
BlockGen.cpp:29-101) to the array-first world: instead of posting one packet
per scheduler callback they yield payload byte arrays (singly or in batches)
for the encoder's [B, L] input.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


class TestGen:
    """Incrementing-counter ASCII packets (TestGen.cpp:36-44): packet i is
    the decimal string of i."""

    __test__ = False  # not a pytest class

    def __init__(self, start: int = 0):
        self.count = start

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        s = str(self.count).encode()
        self.count += 1
        return np.frombuffer(s, np.uint8)

    def batch(self, n: int, pad_to: int | None = None) -> np.ndarray:
        """n packets as a [n, L] uint8 array, space-padded to equal length
        (pad_to overrides the max natural length)."""
        pkts = [next(self) for _ in range(n)]
        L = pad_to if pad_to is not None else max(len(p) for p in pkts)
        out = np.full((n, L), ord(" "), np.uint8)
        for i, p in enumerate(pkts):
            out[i, : len(p)] = p[:L]
        return out


class BlockGen:
    """One user-specified packet of 8/16/32-bit words (BlockGen.cpp:39-91);
    re-armed by setting .elements, mirroring setElements/setTrigger."""

    def __init__(self, elements: Sequence[int] = (), word_bits: int = 8):
        if word_bits not in (8, 16, 32):
            raise ValueError("word_bits must be 8, 16 or 32")
        self.word_bits = word_bits
        self.elements = list(elements)
        self._armed = bool(elements)

    def trigger(self) -> None:
        self._armed = True

    def next(self) -> np.ndarray | None:
        """The packet as bytes (little-endian words), or None if not armed."""
        if not self._armed or not self.elements:
            return None
        self._armed = False
        dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[self.word_bits]
        words = np.asarray(self.elements, dtype=dt)
        return np.frombuffer(words.tobytes(), np.uint8).copy()
