"""Kernel D: the polyphase analysis filterbank (csrc/channelize.cu).

The port of lora_tpu/ops/pallas_channelize.py.  The JAX package has two
filterbank kernels: `_filterbank_fir` (entry `filterbank_fir`, factorized
FIR + IDFT, channel-major output, for 64 <= K <= 256 with K % 64 == 0 and
L <= 8) and `_filterbank` (entry `filterbank`, the dense block-Toeplitz
product, channel-minor output, for the other geometries it fits).  Both
exist to fit the TPU's lanes and VMEM; one CUDA kernel computes the
factorized form for any K and L whose tile fits shared memory and writes
the channel-major [S, K, M] that the demod bank reads.

`filterbank_plain` is the JAX package's XLA pipeline (flipped commutator,
grouped rows, one block-Toeplitz matrix product, corner turn).  The wrapper
`filterbank` takes it only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from . import _cuda, tables
from .channelizer import _grouped_rows, bank_product, default_group

@functools.lru_cache(maxsize=None)
def tile_m(K: int, taps_per_phase: int) -> int:
    """Output samples per block that kernel D picks for (K, L) (csrc/
    channelize.cu, lora_channelize_tile).  Raises ValueError when no tile
    fits shared memory.  Needs the built library."""
    TM = _cuda.library().lora_channelize_tile(K, taps_per_phase)
    if TM == 0:
        raise ValueError(f"channelize kernel: no tile fits K={K}, "
                         f"L={taps_per_phase} in shared memory")
    return TM


@functools.lru_cache(maxsize=None)
def consts(K: int, taps_per_phase: int, device: torch.device):
    """(hp, wk) on `device`: the flip-folded taps float32 [L, K]
    (tables.fir_taps_flipped) and the twiddles complex64 [K],
    wk[j] = e^{+2 pi i j / K} as tables.idft_k rounds them (its row 1)."""
    hp = torch.from_numpy(tables.fir_taps_flipped(K, taps_per_phase))
    wre, wim = tables.idft_k(K)
    wk = torch.complex(torch.from_numpy(wre[1].copy()),
                       torch.from_numpy(wim[1].copy()))
    return hp.to(device), wk.to(device)


def filterbank_plain(xp: torch.Tensor, K: int, taps_per_phase: int,
                     M: int) -> torch.Tensor:
    """State-prepended wideband xp [..., P], P >= (M + L - 1) * K ->
    channel-major y [..., K, M] (lora_tpu/ops/channelizer.py:273-299)."""
    L = taps_per_phase
    lead = xp.shape[:-1]
    rows = M + L - 1
    xrev = xp[..., : rows * K].reshape(*lead, rows, K).flip(-1)
    G = default_group(M)
    y = bank_product(_grouped_rows(xrev, K, L, G), False, K, L, G)
    return y.reshape(*lead, M, K).transpose(-1, -2).contiguous()


def filterbank(xp: torch.Tensor, K: int, taps_per_phase: int,
               M: int) -> torch.Tensor:
    """Kernel D wrapper: same contract as filterbank_plain."""
    if xp.device.type == "cpu":
        return filterbank_plain(xp, K, taps_per_phase, M)
    if not xp.is_cuda:
        raise ValueError(f"filterbank: unsupported device {xp.device}")
    if xp.dtype != torch.complex64:
        raise TypeError(f"filterbank: expected complex64, got {xp.dtype}")
    L = taps_per_phase
    *lead, P = xp.shape
    if P < (M + L - 1) * K:
        raise ValueError(f"filterbank: {P} samples < (M + L - 1) * K = "
                         f"{(M + L - 1) * K}")
    tile_m(K, L)  # raises for a width the kernel does not take
    x2 = xp.reshape(-1, P)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    S = x2.shape[0]
    dev = xp.device
    y = torch.empty((S, K, M), dtype=torch.complex64, device=dev)
    if S and M:
        hp, wk = consts(K, L, dev)
        err = _cuda.library().lora_channelize(
            x2.data_ptr(), x2.stride(0), S, K, L, M, hp.data_ptr(),
            wk.data_ptr(), y.data_ptr(), _cuda.stream(dev),
        )
        _cuda.check(err, "lora_channelize")
        filterbank.launches += 1
    return y.reshape(*lead, K, M)


filterbank.launches = 0
