"""lora_tpu_torch: the LoRa PHY of lora_tpu, ported to PyTorch and CUDA.

The hard-decision receive path (encode, modulate, demodulate, decode) runs
on an NVIDIA Hopper card through hand-written CUDA kernels (csrc/) and on
the CPU through their plain PyTorch versions.  The configuration type is
shared with the JAX package (`lora_tpu.config.LoRaConfig`, which imports no
jax).  The package imports torch and numpy, never jax.
"""

from lora_tpu.config import CODING_RATES, LoRaConfig

__all__ = ["LoRaConfig", "CODING_RATES"]
