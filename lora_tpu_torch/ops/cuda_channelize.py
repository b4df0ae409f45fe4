"""Kernel D: the polyphase analysis filterbank (csrc/channelize.cu).

The port of lora_tpu/ops/pallas_channelize.py.  The JAX package has two
filterbank kernels: `_filterbank_fir` (entry `filterbank_fir`, factorized
FIR + IDFT, channel-major output, for 64 <= K <= 256 with K % 64 == 0 and
L <= 8) and `_filterbank` (entry `filterbank`, the dense block-Toeplitz
product, channel-minor output, for the other geometries it fits).  Both
exist to fit the TPU's lanes and VMEM; one CUDA source computes the
factorized form for any K and L whose tile fits shared memory and writes
the channel-major [S, K, M] that the demod bank reads.  It picks its route
by K and the bf16 flag (`route`): in float32 a register FFT for the powers
of two from 8 to 1024 (1) and the direct sum over the phases for every
other K (2); with bf16 the tensor cores' product at every K (3).

The kernel reads the filter history and the block through two pointers, so
the wrapper `filterbank` takes them apart, (x, state), and nothing
concatenates them on the card.  `filterbank_plain` is the JAX package's XLA
pipeline (flipped commutator, grouped rows, one block-Toeplitz matrix
product, corner turn) over the concatenated stream.  The wrapper takes it
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.

With bf16=True the kernel computes what the JAX package's `_filterbank_fir`
computes on a TPU with bf16=True: the float32 FIR output u rounded to
bfloat16 (route 2's fmaf chain, so u is bit-equal to the plain version's),
then the K-point IDFT as one real product on the tensor cores
(mma.sync m16n8k16, float32 sums) by the rounded matrix
`idft_flipped(K)`, which `idft_packed` lays out in the order the kernel's
A fragments load it: each 16-row tile holds 8 channels' real parts over
their imaginary parts, and K is padded with zeros to a multiple of 16.  Its
plain version is `filterbank_fir_plain`, the same roundings and one float32
matrix product, which the tests and chip_smoke.py hold it against (within
the BF16_* bars: the tensor cores sum in another order).  For a CPU tensor
the wrapper gives what the JAX package gives off a TPU, the plain product
with both operands rounded (`filterbank_plain(..., bf16=True)`).

Route 3 replaced the direct sum with rounded operands that bf16 took at
every K before (route 2 on the float32 cores).  At config 3 (S = 256, K =
64, M = 10,240) it reads 1.179 ms against that route's 4.580 in one call
(tools/torch_kernel_probe.py, NVIDIA H100 80GB HBM3, 700.00 W), as fast as
the float32 route 1; the other widths, and what was tried and not kept,
are in channelize.cu's header (route 3) and in PERF.md.
"""

from __future__ import annotations

import functools
import math

import torch

from . import _cuda, cplx, tables
from .channelizer import _grouped_rows, bank_product, default_group, prepended


@functools.lru_cache(maxsize=None)
def route(K: int, taps_per_phase: int, bf16: bool = False) -> int:
    """The route kernel D takes for (K, L) (csrc/channelize.cu,
    lora_channelize_route): in float32 1 the register FFT, 2 the direct
    sum; with bf16 3, the tensor cores' product (every K).  Raises
    ValueError when no tile fits shared memory.  Needs the built library."""
    r = _cuda.library().lora_channelize_route(K, taps_per_phase, int(bf16))
    if r == 0:
        raise ValueError(f"channelize kernel: no tile fits K={K}, "
                         f"L={taps_per_phase} in shared memory")
    return r


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
                     M: int, bf16: bool = False) -> torch.Tensor:
    """State-prepended wideband xp [..., P], P >= (M + L - 1) * K ->
    channel-major y [..., K, M] (lora_tpu/ops/channelizer.py:273-299); bf16
    rounds both operands of the product to bfloat16."""
    L = taps_per_phase
    lead = xp.shape[:-1]
    rows = M + L - 1
    xrev = xp[..., : rows * K].reshape(*lead, rows, K).flip(-1)
    G = default_group(M)
    y = bank_product(_grouped_rows(xrev, K, L, G), False, K, L, G, bf16)
    return y.reshape(*lead, M, K).transpose(-1, -2).contiguous()


@functools.lru_cache(maxsize=None)
def idft_flipped(K: int, device: torch.device) -> torch.Tensor:
    """complex64 [K, K] W'[q, k] = W[K-1-q, k], W = tables.idft_k (the
    commutator's lane flip folded in), rounded to bfloat16: the matrix of
    lora_tpu's _fir_idft_consts (pallas_channelize.py:264) with bf16=True."""
    wre, wim = tables.idft_k(K)
    w = torch.complex(torch.from_numpy(wre), torch.from_numpy(wim)).flip(0)
    return cplx.round_bf16(w).to(device)


def mma_width(K: int) -> int:
    """K padded to whole pairs of 8-channel A tiles: the width of route 3's
    real product (channelize.cu mma_width)."""
    return -(-K // 16) * 16


@functools.lru_cache(maxsize=None)
def idft_packed(K: int, device: torch.device) -> torch.Tensor:
    """Route 3's matrix: bfloat16 [KW/8, KW/8, 32, 8], KW = mma_width(K),
    the real form Wbig of idft_flipped(K) (zero past K) in mma.sync's A
    fragment order.  Tile t holds channels 8t .. 8t+7, their real parts in
    rows 0-7 and imaginary parts in rows 8-15; k-step ks holds phases
    8ks .. 8ks+7, re and im interleaved.  Lane l = 4g + i of tile (t, ks)
    holds (Wr, -Wi, Wi, Wr) of W'[q, k] at (q, k) = (8ks + i, 8t + g), then
    at q + 4: its registers a0a1, a2a3, a4a5, a6a7, one 16-byte load."""
    KW = mma_width(K)
    w = torch.zeros((KW, KW), dtype=torch.complex64)
    w[:K, :K] = idft_flipped(K, torch.device("cpu"))
    n = KW // 8
    lane = torch.arange(32)
    k = 8 * torch.arange(n)[:, None, None] + (lane // 4)[None, None, :]
    q = 8 * torch.arange(n)[None, :, None] + (lane % 4)[None, None, :]
    a, b = w[q, k], w[q + 4, k]  # [tile, k-step, lane]
    parts = (a.real, -a.imag, a.imag, a.real, b.real, -b.imag, b.imag, b.real)
    return torch.stack(parts, -1).to(torch.bfloat16).to(device)


def filterbank_fir_plain(xp: torch.Tensor, K: int, taps_per_phase: int,
                         M: int) -> torch.Tensor:
    """Kernel D's bf16 route in plain PyTorch, the factorized form with
    bf16=True (lora_tpu/ops/pallas_channelize.py:296-330): the FIR over the
    flipped commutator in float32, taps in kernel D's order
    (tables.fir_taps_flipped) and rounded as its fmaf chain rounds them;
    its output rounded to bfloat16, then the K-point IDFT by the rounded
    matrix as one product in full float32.  State-prepended xp [..., P] ->
    channel-major y [..., K, M]."""
    L = taps_per_phase
    lead = xp.shape[:-1]
    x2 = torch.view_as_real(xp[..., : (M + L - 1) * K].reshape(
        *lead, M + L - 1, K))
    hp, _ = consts(K, L, xp.device)
    u = hp[L - 1, :, None] * x2[..., :M, :, :]
    for d in range(1, L):
        # fmaf(h, x, u): the float32 product is exact in float64, so the
        # step rounds once to float32 after the add (twice, through
        # float64, only on a float32 midpoint the double sum lands on)
        h = hp[L - 1 - d, :, None].double()
        u = (h * x2[..., d : d + M, :, :].double() + u.double()).float()
    u = cplx.round_bf16(torch.view_as_complex(u))
    with cplx.full_float32():
        y = torch.matmul(u, idft_flipped(K, xp.device))
    return y.transpose(-1, -2).contiguous()


def filterbank(x: torch.Tensor, K: int, taps_per_phase: int,
               state: torch.Tensor | None = None,
               bf16: bool = False) -> torch.Tensor:
    """Kernel D wrapper: the block x [..., M*K] after the filter history
    state [..., L*K - 1] (None: zeros) -> channel-major y [..., K, M], what
    filterbank_plain gives for prepended(x, state, L*K - 1).  With bf16 the
    kernel (route 3) computes what filterbank_fir_plain gives, up to the
    order of its float32 sums, and a CPU tensor gets
    filterbank_plain(..., bf16=True), as channelize does."""
    L = taps_per_phase
    *lead, T = x.shape
    hist = L * K - 1
    if T % K:
        raise ValueError(f"filterbank: block length {T} not divisible by "
                         f"K={K}")
    if state is not None and tuple(state.shape) != (*lead, hist):
        raise ValueError(f"filterbank: expected a state of shape "
                         f"{(*lead, hist)}, got {tuple(state.shape)}")
    M = T // K
    if x.device.type == "cpu":
        return filterbank_plain(prepended(x, state, hist), K, L, M, bf16)
    if not x.is_cuda:
        raise ValueError(f"filterbank: unsupported device {x.device}")
    for name, t in (("x", x), ("state", state)):
        if t is None:
            continue
        if t.dtype != torch.complex64:
            raise TypeError(f"filterbank: expected complex64 {name}, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"filterbank: state on {t.device}, x on "
                             f"{x.device}")
    route(K, L, bf16)  # raises for a width the kernel does not take
    S = math.prod(lead)
    dev = x.device
    y = torch.empty((S, K, M), dtype=torch.complex64, device=dev)
    if S and M:
        rows = lambda t, n: (t.reshape(S, n) if t.stride(-1) == 1
                             else t.reshape(S, n).contiguous())
        x2 = rows(x, T)
        h2 = None if state is None else rows(state, hist)
        hp, wk = consts(K, L, dev)
        args = (None if h2 is None else h2.data_ptr(),
                0 if h2 is None else h2.stride(0), x2.data_ptr(),
                x2.stride(0), S, K, L, M, hp.data_ptr())
        lib = _cuda.library()
        if bf16:
            err = lib.lora_channelize_bf16(
                *args, idft_packed(K, dev).data_ptr(), y.data_ptr(),
                _cuda.stream(dev))
            _cuda.check(err, "lora_channelize_bf16")
        else:
            err = lib.lora_channelize(*args, wk.data_ptr(), y.data_ptr(),
                                      _cuda.stream(dev), 0)
            _cuda.check(err, "lora_channelize")
    return y.reshape(*lead, K, M)
