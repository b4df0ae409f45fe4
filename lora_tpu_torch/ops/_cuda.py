"""Build and load the port's CUDA kernels (csrc/*.cu).

The sources are compiled with nvcc for sm_90a into one shared library with
a plain C interface, at first use, under build/lora_tpu_torch/ at the root
of the checkout, and loaded with ctypes.  The library's name carries a hash
of the sources and flags, so an edited source is rebuilt.  Nothing here
runs at import time: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from . import tables
from .chirp import dechirp_table

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "lora_tpu_torch"
SOURCES = ("detect.cu", "track.cu", "payload.cu")
HEADERS = ("detect.cuh",)
# no --use_fast_math: full-precision sincosf/log10f/sqrtf keep the dB values
# and the derotation on the plain version's float32 rounding
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    "lora_detect": [_P, _L, _L, _L, _I, _P, _P, _P, _F, _F, _I, _P, _P, _P,
                    _P, _P],
    "lora_track": [_P, _L, _L, _L, _I, _P, _I, _I, _F, _P, _P, _P, _F, _F,
                   _P, _P, _P, _P, _P, _P, _P],
    "lora_payload": [_P, _L, _L, _L, _I, _I, _P, _P, _P, _P, _F, _F, _P, _P,
                     _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"liblora_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless the library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def consts(N: int, device: torch.device):
    """(up table, down table, twiddles, rot_scale, db_scale) for size N:
    complex64 tensors on `device` and the two float32 scalars the kernels
    take, rounded as the plain version rounds them."""
    tw = torch.view_as_complex(torch.as_tensor(tables.fft_twiddles_np(N)))
    return (
        dechirp_table(N, False, device),
        dechirp_table(N, True, device),
        tw.to(device),
        float(np.float32(-2 * math.pi / N)),
        float(np.float32(20.0 * np.log10(N))),
    )


def check_window_size(N: int) -> None:
    if N < 64 or N > 4096 or N & (N - 1):
        raise ValueError(f"kernels take power-of-two N in [64, 4096], got {N}")


def check_buffer(x: torch.Tensor, name: str) -> None:
    """A complex64 [B, T] CUDA tensor whose rows are contiguous."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.complex64:
        raise TypeError(f"{name}: expected complex64, got {x.dtype}")
    if x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"{name}: expected [B, T] with contiguous rows")


def on_device(t, dtype, device, shape, name: str) -> torch.Tensor:
    """Coerce a per-channel argument to a contiguous tensor of `shape`."""
    t = torch.as_tensor(t, device=device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.to(dtype).contiguous()
