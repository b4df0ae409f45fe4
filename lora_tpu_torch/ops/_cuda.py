"""Build and load the port's CUDA kernels (csrc/*.cu).

The sources are compiled with nvcc for sm_90a (one process per source, all
started together) and linked into one shared library with a plain C
interface, at first use, under build/lora_tpu_torch/ at the root
of the checkout, and loaded with ctypes.  The library's name carries a hash
of the sources and flags, so an edited source is rebuilt.  Nothing here
runs at import time: the CPU tests import every module of the port.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

from . import tables
from .chirp import dechirp_table

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "lora_tpu_torch"
SOURCES = ("detect.cu", "track.cu", "payload.cu", "channelize.cu", "shift.cu",
           "modulate.cu", "decode.cu", "resample.cu")
HEADERS = ("detect.cuh", "fft.cuh")
# no --use_fast_math: full-precision sincosf/log10f/sqrtf keep the dB values
# and the derotator's two factors on the plain version's float32 rounding.
# -fno-gnu-unique: a static local of a launch template (its cache of launch
# queries) stays this library's own when a process loads two builds of the
# sources, as tools/torch_kernel_probe.py does to time them in turns
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xcompiler", "-fno-gnu-unique")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    "lora_detect": [_P, _L, _L, _L, _I, _P, _P, _P, _F, _F, _I, _P, _P, _P,
                    _P, _P],
    "lora_track": [_P, _L, _L, _I, _L, _I, _P, _I, _I, _F, _P, _P, _P, _F, _F,
                   _P, _P, _P, _P, _P, _P, _P],
    "lora_payload": [_P, _L, _L, _I, _L, _I, _I, _P, _P, _P, _P, _F, _F, _P,
                     _P, _P, _P, _P],
    "lora_channelize": [_P, _L, _P, _L, _L, _I, _I, _L, _P, _P, _P, _P, _I],
    "lora_channelize_bf16": [_P, _L, _P, _L, _L, _I, _I, _L, _P, _P, _P, _P],
    "lora_channelize_route": [_I, _I, _I],
    "lora_shift": [_P, _L, _L, _I, _I, _P, _P, _P],
    "lora_modulate": [_P, _L, _I, _P, _I, _I, _I, _I, _L, _F, _F, _P, _P],
    "lora_decode": [_P, _I, _L, _I, _L, _L, _I, _I, _I, _I, _I, _I, _I, _I,
                    _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "lora_resample": [_P, _L, _L, _L, _L, _P, _L, _I, _P, _I, _I, _P, _P],
    "lora_resample_blocked": [_P, _L, _L, _L, _L, _P, _L, _I, _P, _I, _I, _I,
                              _P, _L, _P, _P],
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


def _run_together(cmds) -> None:
    """Start every nvcc command at once and wait for all; raise with the
    output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}{err}")


def build() -> pathlib.Path:
    """Compile the kernels unless the library for these sources exists: one
    nvcc per source, all started together, then one link."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
            objs = [os.path.join(objdir, s + ".o") for s in SOURCES]
            _run_together([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
                           for s, o in zip(SOURCES, objs)])
            _run_together([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
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


# A captured program's launches (utils/jit.py) are tallied in the thread
# that captures, not counted: the capture keeps them as the graph's credit
# and each replay adds them.  A launch in another thread meanwhile (a bank
# built in a thread) counts as usual.
_capture = threading.local()
_COUNTS = threading.Lock()


def launched(wrapper, counter: str = "launches") -> None:
    """Count one launch of a kernel wrapper on its `counter` (`.launches`,
    or another count of the wrapper's such as `.blocked`), where it
    launches."""
    key = wrapper if counter == "launches" else (wrapper, counter)
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[key] = tally.get(key, 0) + 1
    else:
        credit(key, 1)


def credit(key, n: int) -> None:
    """Add n to a wrapper's `.launches` (key: the wrapper) or to its other
    counter (key: (wrapper, counter))."""
    wrapper, counter = key if isinstance(key, tuple) else (key, "launches")
    with _COUNTS:
        setattr(wrapper, counter, getattr(wrapper, counter) + n)


@contextlib.contextmanager
def tally():
    """Tally this thread's launches in the dict it yields instead of
    counting them (a graph's capture)."""
    prev = getattr(_capture, "tally", None)
    _capture.tally = counted = {}
    try:
        yield counted
    finally:
        _capture.tally = prev


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
