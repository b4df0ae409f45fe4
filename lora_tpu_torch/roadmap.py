"""Routes of lora_tpu that the port has no counterpart for.

Each raises NotImplementedError naming why; none falls back in silence to
another route."""

from __future__ import annotations


def no_counterpart(what: str) -> NotImplementedError:
    """A route of lora_tpu that runs its Pallas kernels in the JAX
    interpreter: the port's kernels are CUDA, which has no such mode."""
    return NotImplementedError(
        f"{what} has no CUDA counterpart: it runs lora_tpu's Pallas kernels "
        "in the JAX interpreter; the port's kernels run on the card "
        "(fused='auto') and their plain PyTorch versions anywhere "
        "(fused='off')")
