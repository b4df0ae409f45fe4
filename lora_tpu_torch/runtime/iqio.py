"""ctypes bindings for the native IQ ingest library (runtime/native/iqio.cpp;
a copy of lora_tpu/runtime/iqio.py that builds elsewhere).

g++ compiles the library at first use into build/lora_tpu_torch/ at the
root of the checkout (ops/_cuda.BUILD_DIR), under a name hashed from the
source and flags, never into the package directory; it writes a temporary
file and renames it into place, so processes that build at once never load
half a file.  Every entry point has a numpy fallback, so ingest works
without a toolchain: it is host work, not the device's (the role the
reference delegates to Pothos buffer managers and SoapySDR,
LoRaDemod.cpp:330-358, RN2483Capture.py:45-53).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

from ..ops._cuda import BUILD_DIR

SOURCE = pathlib.Path(__file__).resolve().parent / "native" / "iqio.cpp"
# no -march=native: the library must load on whatever host runs the checkout
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_lib_tried = False


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libiqio_{h.hexdigest()[:16]}.so"


def _build(so: pathlib.Path) -> bool:
    """Compile the library to `so` through a temporary file; False when g++
    is missing or fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        for name, argt in [
            ("iq_convert_cs8", [ctypes.c_void_p, f32p, f32p, i64, ctypes.c_float]),
            ("iq_convert_cu8", [ctypes.c_void_p, f32p, f32p, i64, ctypes.c_float]),
            ("iq_convert_cs16", [ctypes.c_void_p, f32p, f32p, i64, ctypes.c_float]),
            ("iq_convert_cf32", [ctypes.c_void_p, f32p, f32p, i64, ctypes.c_float]),
            ("iq_interleave_cf32", [f32p, f32p, f32p, i64]),
            ("iq_ring_write", [ctypes.c_void_p, f32p, f32p, i64]),
            ("iq_ring_read", [ctypes.c_void_p, f32p, f32p, i64]),
        ]:
            getattr(lib, name).argtypes = argt
        lib.iq_ring_create.argtypes = [i64]
        lib.iq_ring_create.restype = ctypes.c_void_p
        lib.iq_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.iq_ring_available.argtypes = [ctypes.c_void_p]
        lib.iq_ring_available.restype = i64
        lib.iq_ring_dropped.argtypes = [ctypes.c_void_p]
        lib.iq_ring_dropped.restype = i64
        for name in ("iq_ring_write", "iq_ring_read"):
            getattr(lib, name).restype = i64
        _lib = lib
        return _lib


_FORMATS = {
    "cs8": (np.int8, "iq_convert_cs8", 1.0 / 128.0),
    "cu8": (np.uint8, "iq_convert_cu8", 1.0 / 128.0),
    "cs16": (np.int16, "iq_convert_cs16", 1.0 / 32768.0),
    "cf32": (np.float32, "iq_convert_cf32", 1.0),
}


def convert(raw: bytes | np.ndarray, fmt: str, scale: float | None = None,
            out: tuple | None = None):
    """Interleaved wire-format samples -> planar (re, im) float32 arrays,
    written into `out`, a pair of contiguous float32 arrays of the sample
    count (such as pinned staging), when given."""
    if fmt not in _FORMATS:
        raise ValueError(f"unknown IQ format {fmt!r} (want {list(_FORMATS)})")
    dtype, fname, default_scale = _FORMATS[fmt]
    scale = default_scale if scale is None else scale
    buf = np.frombuffer(raw, dtype=dtype) if isinstance(raw, (bytes, bytearray)) else np.asarray(raw, dtype)
    n = buf.size // 2
    if out is None:
        re = np.empty(n, np.float32)
        im = np.empty(n, np.float32)
    else:
        re, im = out
        if not all(a.dtype == np.float32 and a.size == n
                   and a.flags.c_contiguous for a in out):
            raise ValueError(f"out: two contiguous float32 arrays of {n}")
    lib = get_lib()
    if lib is not None:
        fp = ctypes.POINTER(ctypes.c_float)
        getattr(lib, fname)(
            buf.ctypes.data_as(ctypes.c_void_p),
            re.ctypes.data_as(fp),
            im.ctypes.data_as(fp),
            n,
            scale,
        )
    else:  # numpy fallback; trim odd trailing scalars (truncated capture
        # tail / short SDR read) so this path matches the native one, which
        # processes n = size // 2 samples
        f = buf[: 2 * n].astype(np.float32).reshape(n, 2)
        if fmt == "cu8":
            f = f - 127.5
        re[:] = scale * f[:, 0]
        im[:] = scale * f[:, 1]
    return re, im


def interleave_cf32(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """Planar -> interleaved cf32 (TX emission path)."""
    re = np.ascontiguousarray(re, np.float32)
    im = np.ascontiguousarray(im, np.float32)
    out = np.empty(re.size * 2, np.float32)
    lib = get_lib()
    if lib is not None:
        fp = ctypes.POINTER(ctypes.c_float)
        lib.iq_interleave_cf32(
            re.ctypes.data_as(fp), im.ctypes.data_as(fp),
            out.ctypes.data_as(fp), re.size,
        )
    else:
        out[0::2] = re
        out[1::2] = im
    return out


class IqRing:
    """Planar SPSC ring buffer between an ingest thread and the dispatcher.

    Native-backed when the library is available; a numpy+lock fallback
    otherwise (same API, lower throughput).
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lib = get_lib()
        if self._lib is not None:
            self._h = self._lib.iq_ring_create(capacity)
            if not self._h:
                raise MemoryError("iq_ring_create failed")
        else:
            self._re = np.zeros(capacity, np.float32)
            self._im = np.zeros(capacity, np.float32)
            self._head = 0
            self._tail = 0
            self._drop = 0
            self._mu = threading.Lock()

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.iq_ring_destroy(self._h)
            self._h = None

    @property
    def available(self) -> int:
        if self._lib is not None:
            return self._lib.iq_ring_available(self._h)
        with self._mu:
            return self._head - self._tail

    @property
    def dropped(self) -> int:
        if self._lib is not None:
            return self._lib.iq_ring_dropped(self._h)
        with self._mu:
            return self._drop

    def write(self, re: np.ndarray, im: np.ndarray) -> int:
        re = np.ascontiguousarray(re, np.float32)
        im = np.ascontiguousarray(im, np.float32)
        if self._lib is not None:
            fp = ctypes.POINTER(ctypes.c_float)
            return self._lib.iq_ring_write(
                self._h, re.ctypes.data_as(fp), im.ctypes.data_as(fp), re.size
            )
        with self._mu:
            space = self.capacity - (self._head - self._tail)
            todo = min(re.size, space)
            self._drop += re.size - todo
            pos = self._head % self.capacity
            first = min(todo, self.capacity - pos)
            self._re[pos : pos + first] = re[:first]
            self._im[pos : pos + first] = im[:first]
            if todo > first:
                self._re[: todo - first] = re[first:todo]
                self._im[: todo - first] = im[first:todo]
            self._head += todo
            return todo

    def read(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        re = np.empty(n, np.float32)
        im = np.empty(n, np.float32)
        if self._lib is not None:
            fp = ctypes.POINTER(ctypes.c_float)
            got = self._lib.iq_ring_read(
                self._h, re.ctypes.data_as(fp), im.ctypes.data_as(fp), n
            )
            return re[:got], im[:got]
        with self._mu:
            avail = self._head - self._tail
            todo = min(n, avail)
            pos = self._tail % self.capacity
            first = min(todo, self.capacity - pos)
            re[:first] = self._re[pos : pos + first]
            im[:first] = self._im[pos : pos + first]
            if todo > first:
                re[first:todo] = self._re[: todo - first]
                im[first:todo] = self._im[: todo - first]
            self._tail += todo
            return re[:todo], im[:todo]
