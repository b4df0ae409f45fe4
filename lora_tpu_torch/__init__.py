"""lora_tpu_torch: the LoRa PHY of lora_tpu, ported to PyTorch and CUDA.

The receive path (encode, modulate, demodulate, decode, soft decisions),
the wideband channelized front end, the streaming runtime, capture replay,
the CLI, the multi-device paths (parallel/, on torch.distributed) and the
headline benchmark (benchmarks.py) run on an NVIDIA Hopper card through
hand-written CUDA kernels
(csrc/) and on the CPU through their plain PyTorch versions.  The package
imports torch and numpy: never jax, and nothing of the JAX package (the
jax-free modules it needs are its own copies).

The top-level names resolve lazily, as in lora_tpu: `import
lora_tpu_torch` loads only the config.
"""

from .config import CODING_RATES, LoRaConfig

__all__ = ["LoRaConfig", "CODING_RATES"]

_API = ("encode", "decode", "decode_soft", "soft_symbols", "modulate",
        "demodulate", "DecodeResult", "DemodResult", "loopback",
        "required_samples", "extract_payloads")
_SUBPACKAGES = ("runtime", "api", "models", "ops", "sim", "utils", "hw",
                "parallel")


def __getattr__(name):
    if name in _API:
        from . import api

        return getattr(api, name)
    if name in ("debug_checks", "DemodCheckError"):
        from .utils import debugcheck

        return getattr(debugcheck, name)
    if name in _SUBPACKAGES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    if name == "IQ":
        raise AttributeError(
            "lora_tpu_torch has no IQ: the port keeps IQ as complex64 "
            "tensors (ops/cplx.py), not lora_tpu's planar pair")
    raise AttributeError(name)
