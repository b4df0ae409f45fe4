"""Row gather and per-channel sub-window shift (port of lora_tpu/ops/shift.py).

The unfused routes of the demodulator (the plain versions of kernels B and
C, and the debug taps) cut each channel's windows at a per-channel sample
offset t in two steps, as the JAX package does: gather the aligned rows
from t // N, then shift every window by t % N.  Kernels B and C read each
window at its own offset and need neither; the debug taps return the
shifted windows themselves, so their shift is kernel E (csrc/shift.cu).

Both functions take leading axes [B, *k]: [B] for one frame per buffer,
[B, K] for the K candidates of max_frames = K.
"""

from __future__ import annotations

import math

import torch

from . import _cuda


def gather_rows(x: torch.Tensor, q: torch.Tensor, n_rows: int,
                N: int) -> torch.Tensor:
    """x [B, T]; q int [B, *k] row indices on the N grid ->
    [B, *k, n_rows, N] = x[b, (q+j)*N : (q+j+1)*N], q clamped so every row
    lies in the buffer."""
    B, T = x.shape
    rows_total = T // N
    q = torch.clamp(q.long(), 0, max(0, rows_total - n_rows))
    idx = q[..., None] + torch.arange(n_rows, device=x.device)
    a3 = x[:, : rows_total * N].reshape(B, rows_total, N)
    g = torch.take_along_dim(a3, idx.reshape(B, -1)[:, :, None], dim=1)
    return g.reshape(*q.shape, n_rows, N)


def _flat(g: torch.Tensor, r: torch.Tensor, mtu: int, check_range: bool):
    """Check the contract shared by the kernel and its plain version and
    flatten the leading axes: g [*lead, R, N], r [*lead] ->
    (g [BF, R, N], r [BF], lead).  check_range reads r's extremes on the
    host, which stalls it when r lies on the card; under a CUDA graph's
    capture it is a device-side assertion instead."""
    if g.dim() < 3:
        raise ValueError(f"shift_windows: rows of shape {tuple(g.shape)}, "
                         "expected [B, *k, R, N]")
    *lead, R, N = g.shape
    if R < mtu + 1:
        raise ValueError(f"shift_windows: {R} rows < mtu + 1 = {mtu + 1}")
    if tuple(r.shape) != tuple(lead):
        raise ValueError(f"shift_windows: r of shape {tuple(r.shape)}, "
                         f"expected {tuple(lead)}")
    if r.is_floating_point() or r.is_complex():
        raise TypeError(f"shift_windows: r must be an integer tensor, "
                        f"got {r.dtype}")
    BF = math.prod(lead)
    if BF and check_range:
        if r.is_cuda and torch.cuda.is_current_stream_capturing():
            # a captured program cannot read r back: the card asserts it
            torch._assert_async(((r >= 0) & (r < N)).all(),
                                f"shift_windows: r outside [0, {N})")
        else:
            lo, hi = (int(v) for v in torch.aminmax(r))
            if lo < 0 or hi >= N:
                raise ValueError(f"shift_windows: r in [{lo}, {hi}], "
                                 f"expected [0, {N})")
    return g.reshape(BF, R, N), r.reshape(BF), tuple(lead)


def shift_windows_plain(g: torch.Tensor, r: torch.Tensor,
                        mtu: int) -> torch.Tensor:
    """g [B, *k, R, N] aligned rows (R >= mtu + 1); r int [B, *k] in [0, N)
    -> [B, *k, mtu, N] with window w = g[..., w, r:] ++ g[..., w+1, :r].
    The plain version of kernel E, on any device.  The range of r is checked
    where that costs no device sync (r on the CPU); on the card an r out of
    range is the caller's fault, as it is for any index tensor."""
    gf, rf, lead = _flat(g, r, mtu, check_range=not r.is_cuda)
    BF, R, N = gf.shape
    # rows are contiguous in gf, so window w is the flat span w*N + r + [0, N)
    base = torch.arange(mtu * N, device=g.device)
    idx = base + rf.long()[:, None]
    out = torch.take_along_dim(gf.reshape(BF, R * N), idx, dim=1)
    return out.reshape(*lead, mtu, N)


def shift_windows(g: torch.Tensor, r: torch.Tensor, mtu: int) -> torch.Tensor:
    """Kernel E wrapper: same contract as shift_windows_plain, for complex64
    rows.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if g.device.type == "cpu":
        return shift_windows_plain(g, r, mtu)
    if not g.is_cuda:
        raise ValueError(f"shift_windows: unsupported device {g.device}")
    if g.dtype != torch.complex64:
        raise TypeError(f"shift_windows: expected complex64, got {g.dtype}")
    # the kernel reads at g + r unchecked, so r's range is checked here
    gf, rf, lead = _flat(g, r, mtu, check_range=True)
    BF, R, N = gf.shape
    if N % 2:
        raise ValueError(f"shift_windows: odd window size {N}")
    if gf.stride(2) != 1 or gf.stride(1) != N or gf.stride(0) % 2 \
            or gf.data_ptr() % 16:
        raise ValueError("shift_windows: expected contiguous rows, each "
                         "channel 16-byte aligned")
    rf = _cuda.on_device(rf, torch.int32, g.device, (BF,), "r")
    out = torch.empty((BF, mtu, N), dtype=torch.complex64, device=g.device)
    err = _cuda.library().lora_shift(
        gf.data_ptr(), gf.stride(0), BF, N, mtu, rf.data_ptr(),
        out.data_ptr(), _cuda.stream(g.device))
    _cuda.check(err, "lora_shift")
    return out.reshape(*lead, mtu, N)
