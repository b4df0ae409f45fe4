"""Parts of lora_tpu that the port does not carry, by ROADMAP.md item.

Each raises NotImplementedError naming why; none falls back in silence to
another route."""

from __future__ import annotations

ITEMS = {
    1: "the port's bench and BENCHMARK.json",
    3: "parallel/ on torch.distributed",
    5: "the channelizer's bfloat16 contraction",
}


def not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md item {item}: {ITEMS[item]})")


def no_counterpart(what: str) -> NotImplementedError:
    """A route of lora_tpu that runs its Pallas kernels in the JAX
    interpreter: the port's kernels are CUDA, which has no such mode."""
    return NotImplementedError(
        f"{what} has no CUDA counterpart: it runs lora_tpu's Pallas kernels "
        "in the JAX interpreter; the port's kernels run on the card "
        "(fused='auto') and their plain PyTorch versions anywhere "
        "(fused='off')")
