"""Row gather and per-channel sub-window shift (port of lora_tpu/ops/shift.py).

The plain route of the demodulator cuts each channel's windows at a
per-channel sample offset t in two steps, as the JAX package does: gather
the aligned rows from t // N, then shift every window by t % N.  The CUDA
kernels read each window at its own offset and need neither.
"""

from __future__ import annotations

import torch


def gather_rows(x: torch.Tensor, q: torch.Tensor, n_rows: int,
                N: int) -> torch.Tensor:
    """x [B, T]; q int [B] row indices on the N grid -> [B, n_rows, N] =
    x[b, (q+j)*N : (q+j+1)*N], q clamped so every row lies in the buffer."""
    B, T = x.shape
    rows_total = T // N
    q = torch.clamp(q.long(), 0, max(0, rows_total - n_rows))
    idx = q[:, None] + torch.arange(n_rows, device=x.device)
    a3 = x[:, : rows_total * N].reshape(B, rows_total, N)
    return torch.take_along_dim(a3, idx[:, :, None], dim=1)


def shift_windows(g: torch.Tensor, r: torch.Tensor, mtu: int) -> torch.Tensor:
    """g [B, R, N] aligned rows (R >= mtu + 1); r int [B] in [0, N) ->
    [B, mtu, N] with window w = g[:, w, r:] ++ g[:, w+1, :r]."""
    B, R, N = g.shape
    # rows are contiguous in g, so window w is the flat span w*N + r + [0, N)
    base = torch.arange(mtu * N, device=g.device)
    idx = base + r.long()[:, None]
    return torch.take_along_dim(g.reshape(B, R * N), idx, dim=1).reshape(
        B, mtu, N
    )
