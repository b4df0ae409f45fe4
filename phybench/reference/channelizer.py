"""The plain polyphase channelizer and its synthesis twin.

A frozen copy of lora_tpu_torch/ops/channelizer.py (`_grouped_rows`,
`bank_product`, `synthesize`), lora_tpu_torch/ops/cuda_channelize.py
(`filterbank_plain`) and lora_tpu_torch/ops/tables.py (`prototype`,
`idft_k`, `fir_idft_matrix`, `fir_dft_syn_matrix`): one block-Toeplitz
matrix product in full float32 (TF32 off).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def prototype(K: int, taps_per_phase: int = 8, beta: float = 8.0):
    L = K * taps_per_phase
    n = np.arange(L) - (L - 1) / 2
    h = np.sinc(n / K) * np.kaiser(L, beta)
    return (h / h.sum()).astype(np.float32)


def _idft_k(K: int) -> np.ndarray:
    p = np.arange(K)
    ang = 2 * np.pi / K * np.outer(p, p)
    return (np.cos(ang).astype(np.float32).astype(np.float64)
            + 1j * np.sin(ang).astype(np.float32).astype(np.float64))


@functools.lru_cache(maxsize=None)
def _matrix(synthesis: bool, K: int, L: int, G: int, device) -> torch.Tensor:
    """complex64 [(L+G-1)*K, G*K]: the analysis bank WB[(r, p), (j, k)] =
    H[j+L-1-r, p] W[p, k], or the synthesis bank WS[(r, k), (j, p)] =
    E[k, p] K h[(j-r+L-1) K + p]."""
    h = prototype(K, L).astype(np.float64)
    W = _idft_k(K)
    R = L + G - 1
    m = np.zeros((R, K, G, K), np.complex128)
    for r in range(R):
        for j in range(G):
            l = j - r + L - 1
            if 0 <= l < L:
                if synthesis:
                    m[r, :, j, :] = W * (K * h.reshape(L, K)[l])[None, :]
                else:
                    m[r, :, j, :] = h.reshape(L, K)[l][:, None] * W
    m = m.reshape(R * K, G * K)
    return torch.complex(torch.from_numpy(m.real.astype(np.float32)),
                         torch.from_numpy(m.imag.astype(np.float32))
                         ).to(device)


@contextlib.contextmanager
def _full_float32():
    prev = (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]
        torch.backends.cudnn.allow_tf32 = prev[2]


def _group(M: int) -> int:
    return next(g for g in (8, 4, 2, 1) if M % g == 0)


def _grouped_rows(a: torch.Tensor, K: int, L: int, G: int) -> torch.Tensor:
    """[..., rows, K] -> [..., Q, R*K]: Z[q, r*K + p] = a[qG + r, p]."""
    R = L + G - 1
    Q = (a.shape[-2] - L + 1) // G
    lead = a.shape[:-2]
    pieces = []
    for r0 in range(0, R, G):
        w = min(G, R - r0) * K
        seg = a[..., r0 : r0 + Q * G, :]
        short = Q * G - seg.shape[-2]
        if short:
            seg = torch.cat([seg, seg.new_zeros((*lead, short, K))], -2)
        pieces.append(seg.reshape(*lead, Q, G * K)[..., :w])
    return torch.cat(pieces, -1)


def channelize(x: torch.Tensor, K: int, taps_per_phase: int = 8
               ) -> torch.Tensor:
    """Wideband [S, M*K] with a zero filter history -> channels
    [S, K, M]."""
    L = taps_per_phase
    S, T = x.shape
    M = T // K
    xp = torch.cat([x.new_zeros((S, L * K - 1)), x], -1)
    rows = M + L - 1
    xrev = xp[:, : rows * K].reshape(S, rows, K).flip(-1)
    G = _group(M)
    with _full_float32():
        y = torch.matmul(_grouped_rows(xrev, K, L, G),
                         _matrix(False, K, L, G, x.device))
    return y.reshape(S, M, K).transpose(-1, -2).contiguous()


def synthesize(u: torch.Tensor, taps_per_phase: int = 8) -> torch.Tensor:
    """Channels [S, K, M] from a zero state -> wideband [S, M*K]."""
    S, K, M = u.shape
    L = taps_per_phase
    rows = torch.cat([u.new_zeros((S, L - 1, K)), u.transpose(-1, -2)], -2)
    G = _group(M)
    with _full_float32():
        x = torch.matmul(_grouped_rows(rows, K, L, G),
                         _matrix(True, K, L, G, u.device))
    return x.reshape(S, M * K)
