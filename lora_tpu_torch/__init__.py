"""lora_tpu_torch: the LoRa PHY of lora_tpu, ported to PyTorch and CUDA.

The hard-decision receive path (encode, modulate, demodulate, decode) and
the wideband channelized front end (channelized_demodulate) run on an
NVIDIA Hopper card through hand-written CUDA kernels (csrc/) and on the CPU
through their plain PyTorch versions.  The package imports torch and
numpy: never jax, and nothing of the JAX package (`config.py` and
`ops/_bitref.py` are its own copies).
"""

from .config import CODING_RATES, LoRaConfig

__all__ = ["LoRaConfig", "CODING_RATES"]
