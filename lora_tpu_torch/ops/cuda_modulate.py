"""Kernel F: a bank of LoRa frames synthesised in one pass (csrc/modulate.cu).

lora_tpu's `modulate` (lora_tpu/models/modulator.py:72) is one jitted
program, which XLA fuses into one pass that writes the IQ bank once; it has
no pallas_call.  Op by op, the same function allocates about 12 times its
output (int64 [B, S, NN] numerators, float32 turns, cos, sin) and moves
more than that again, captured or not.  Kernel F is that fusion: each
block forms its row's symbol end carries and their prefix sum mod D, then
writes each sample once: the frame's head (a table made once per config by
the plain ops), the data chirps, the zero padding.

`frame_plain` is its plain version, the op-by-op route of the same
arithmetic.  The wrapper `frame` takes it only for a tensor that lies on
the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _cuda, cplx
from .chirp import chirp_phase_nums

# csrc/modulate.cu kMaxSymbols: a row's symbol terms in shared memory
MAX_SYMBOLS = 14336
TWO_PI = float(np.float32(2 * math.pi))  # cplx.from_turns' float32 2 pi


def frame_plain(syms: torch.Tensor, head: torch.Tensor, head_carry: int,
                N: int, ovs: int, padding: int, ampl: float) -> torch.Tensor:
    """syms int [B, S] data symbols; head complex64 [H], the frame's head,
    and head_carry its end carry -> complex64 [B, H + (S + padding) * NN]:
    the head, the data upchirps, padding symbols of zeros.  The plain
    version of kernel F, on any device."""
    B, S = syms.shape
    NN, D = N * ovs, N * ovs * ovs
    nums, carries = chirp_phase_nums(syms.long(), NN, N, ovs, False)
    # each symbol starts at the head's end carry plus the exclusive prefix
    # sum of the symbols' end carries before it
    starts = (torch.cumsum(carries, dim=-1) - carries + head_carry) & (D - 1)
    nums = (nums + starts[..., None]) & (D - 1)
    data = cplx.from_turns(nums.to(torch.float32) / D, ampl)
    return torch.cat([
        head.expand(B, -1),
        data.reshape(B, S * NN),
        torch.zeros((B, padding * NN), dtype=torch.complex64,
                    device=syms.device),
    ], dim=-1)


def frame(syms: torch.Tensor, head: torch.Tensor, head_carry: int, N: int,
          ovs: int, padding: int, ampl: float) -> torch.Tensor:
    """Kernel F wrapper: same contract as frame_plain.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (after a cast where
    the symbols are not int32 and contiguous) or raises."""
    if syms.device.type == "cpu":
        return frame_plain(syms, head, head_carry, N, ovs, padding, ampl)
    if not syms.is_cuda:
        raise ValueError(f"modulate: unsupported device {syms.device}")
    if syms.dim() != 2 or syms.is_floating_point() or syms.is_complex():
        raise TypeError(f"modulate: expected integer symbols [B, S], got "
                        f"{syms.dtype} {tuple(syms.shape)}")
    B, S = syms.shape
    if S > MAX_SYMBOLS:
        raise ValueError(f"modulate: {S} symbols a frame, kernel F takes at "
                         f"most {MAX_SYMBOLS}")
    NN, D = N * ovs, N * ovs * ovs
    if D & (D - 1) or 2 * D > 1 << 31:
        raise ValueError(f"modulate: N*ovs^2 = {D} is no power of two "
                         "below 2^31")
    if (head.device != syms.device or head.dtype != torch.complex64
            or head.dim() != 1 or not head.is_contiguous()):
        raise ValueError("modulate: the head must be a contiguous complex64 "
                         "[H] tensor on the symbols' device")
    sy = syms.to(torch.int32).contiguous()
    H = head.shape[0]
    T = H + (S + padding) * NN
    out = torch.empty((B, T), dtype=torch.complex64, device=syms.device)
    err = _cuda.library().lora_modulate(
        sy.data_ptr(), B, S, head.data_ptr(), H, int(head_carry), N, ovs, T,
        TWO_PI, float(np.float32(ampl)), out.data_ptr(),
        _cuda.stream(syms.device))
    _cuda.check(err, "lora_modulate")
    return out
