"""Top-level PHY API of the port: encode / modulate / demodulate / decode
(lora_tpu/api.py, hard-decision single-frame slice)."""

from __future__ import annotations

import numpy as np
import torch

from lora_tpu.config import LoRaConfig

from .models.decoder import OK, STATUS_NAMES, DecodeResult, decode
from .models.demodulator import DemodResult, demodulate, required_samples
from .models.encoder import encode
from .models.modulator import modulate

__all__ = [
    "LoRaConfig",
    "encode",
    "decode",
    "modulate",
    "demodulate",
    "DecodeResult",
    "DemodResult",
    "required_samples",
    "OK",
    "STATUS_NAMES",
    "extract_payloads",
    "loopback",
]


def extract_payloads(result: DecodeResult) -> list[bytes | None]:
    """Each packet's output bytes, or None where it was dropped."""
    data = np.atleast_2d(result.data.cpu().numpy())
    offset = np.atleast_1d(result.offset.cpu().numpy())
    length = np.atleast_1d(result.length.cpu().numpy())
    status = np.atleast_1d(result.status.cpu().numpy())
    out = []
    for i in range(data.shape[0]):
        if status[i] != OK:
            out.append(None)
        else:
            o, n = int(offset[i]), int(length[i])
            out.append(bytes(data[i, o : o + n].tolist()))
    return out


def loopback(payload, cfg: LoRaConfig, noise_amplitude: float = 0.0,
             phase: float = 0.0, cfo_bins: float = 0.0, delay: int = 0,
             seed: int = 0, device=None, fused: str = "auto",
             soft: bool = False):
    """encode -> modulate -> channel -> demodulate -> decode on `device`.
    payload uint8 [B, L] (or [L]).  Returns (DecodeResult, DemodResult)."""
    from .sim import channel as ch

    if soft:
        raise NotImplementedError(
            "soft=True is not ported yet (ROADMAP.md, queue 1: soft-decision "
            "RX)")
    payload = torch.atleast_2d(torch.as_tensor(payload, dtype=torch.uint8,
                                               device=device))
    iq = modulate(encode(payload, cfg), cfg)
    # pad to the demod window plus the delay, rounded up to a 4096 block
    need = -(-(required_samples(cfg) + delay) // 4096) * 4096
    iq = torch.nn.functional.pad(iq, (0, max(0, need - iq.shape[-1])))
    if delay:
        iq = ch.time_offset(iq, delay)[..., :need]
    if cfo_bins:
        iq = ch.cfo(iq, cfo_bins, cfg.N)
    if phase:
        iq = ch.rotate(iq, phase)
    if noise_amplitude:
        gen = torch.Generator(device=iq.device).manual_seed(seed)
        iq = ch.awgn(iq, noise_amplitude, gen)
    dem = demodulate(iq, cfg, fused=fused)
    return decode(dem.symbols, cfg), dem
