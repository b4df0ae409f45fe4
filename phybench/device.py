"""The card a run measures: the checks that refuse a run without one, the
line that names it, the published peaks, and the look for JAX at the end.

The peaks and `bound` are a copy of chip_smoke.py (`HBM_RATE`, `F32_RATE`,
`BF16_RATE`, `bound`, `window_flops`): each input read once and each
output written once at the H100 SXM data sheet's rates.
"""

from __future__ import annotations

import math
import subprocess
import sys

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 operations/s outside
# the tensor cores, dense bfloat16 operations/s on them
HBM_RATE = 3.35e12
F32_RATE = 67e12
BF16_RATE = 989e12

# the JAX package, JAX and its relatives: no run of the benchmark may load
# them (compared by the whole top-level name: the port's name begins with
# the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "lora_tpu")


class NoCard(RuntimeError):
    """No CUDA card, or fewer than the cell asks for."""


def require_cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark "
                     "measures an NVIDIA card and has no CPU fallback")
    n = torch.cuda.device_count()
    if n < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"torch.cuda.device_count() is {n}")


def power_limit() -> str:
    """nvidia-smi's power.limit of card 0, or why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"unread ({type(e).__name__})"


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is forbidden."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def window_flops(N: int, rotate: bool) -> float:
    """Float32 operations of one dechirp -> FFT -> peak window: 5 N log2 N
    for the transform, 6 N for the dechirp product, 8 N more for the
    derotation, 4 N for |X|^2 and its sum."""
    return N * (5 * math.log2(N) + 6 + (8 if rotate else 0) + 4)


def bound_s(nbytes: float, flops: float = 0.0,
            bf16_flops: float = 0.0) -> float:
    """The least time the card could take: the bytes at the memory rate or
    the operations at their type's rate, whichever is longer (seconds)."""
    return max(nbytes / HBM_RATE, flops / F32_RATE + bf16_flops / BF16_RATE)
