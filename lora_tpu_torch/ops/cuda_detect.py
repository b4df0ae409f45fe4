"""Kernel A: batched dechirp + DFT + peak search (csrc/detect.cu).

The port of lora_tpu/ops/pallas_detect.py (`dechirp_detect_pallas`).  Its
plain version is ops/detect.dechirp_detect; the wrapper takes it only for a
tensor that lies on the CPU.  For a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import detect as det_ops
from .detect import DetectResult


def dechirp_detect(x: torch.Tensor, down: bool = False, ferr=None,
                   want_f_index: bool = True) -> DetectResult:
    """Dechirp + detect over complex64 windows [..., N] (fine CFO `ferr` in
    bins, broadcast over the window axes, or None for no derotation).

    A [B, W, N] view whose windows are contiguous rows of channel buffers
    (strides (sB, N, 1), the coarse search's view of [B, T]) is read in
    place; any other layout is made contiguous first."""
    if x.device.type == "cpu":
        return det_ops.dechirp_detect(x, down, ferr, want_f_index=want_f_index)
    if not x.is_cuda:
        raise ValueError(f"dechirp_detect: unsupported device {x.device}")
    if x.dtype != torch.complex64:
        raise TypeError(f"dechirp_detect: expected complex64, got {x.dtype}")
    *lead, N = x.shape
    _cuda.check_window_size(N)
    if x.dim() == 3 and x.stride(2) == 1 and x.stride(1) == N:
        B, W, sB = x.shape[0], x.shape[1], x.stride(0)
    else:
        x = x.reshape(-1, N).contiguous()
        B, W, sB = 1, x.shape[0], x.shape[0] * N
    M = B * W
    dev = x.device
    fe = None
    if ferr is not None:
        fe = torch.broadcast_to(
            torch.as_tensor(ferr, dtype=torch.float32, device=dev), lead
        ).reshape(M).contiguous()
    value = torch.empty(M, dtype=torch.int32, device=dev)
    power = torch.empty(M, dtype=torch.float32, device=dev)
    noise = torch.empty(M, dtype=torch.float32, device=dev)
    findex = (torch.empty(M, dtype=torch.float32, device=dev) if want_f_index
              else torch.zeros(M, dtype=torch.float32, device=dev))
    up, dn, tw, rot_scale, db_scale = _cuda.consts(N, dev)
    err = _cuda.library().lora_detect(
        x.data_ptr(), sB, B, W, N, fe.data_ptr() if fe is not None else None,
        (dn if down else up).data_ptr(), tw.data_ptr(), rot_scale, db_scale,
        int(want_f_index), value.data_ptr(), power.data_ptr(),
        noise.data_ptr(), findex.data_ptr() if want_f_index else None,
        _cuda.stream(dev),
    )
    _cuda.check(err, "lora_detect")
    shp = lambda a: a.reshape(lead)
    return DetectResult(value=shp(value), power=shp(power), noise=shp(noise),
                        f_index=shp(findex))
