"""The kernels' build and launch glue (lora_tpu_torch/ops/_cuda.py) on the
CPU: the library is named by its sources, a missing nvcc is reported, the
argument checks refuse what the kernels do not take, and the constants
the kernels receive are the plain version's."""

import math
import sys

import numpy as np
import pytest
import torch

from lora_tpu_torch.ops import _cuda, chirp, tables

torch.set_num_threads(1)


def test_library_named_by_sources_and_flags(monkeypatch):
    so = _cuda.library_path()
    assert so.parent == _cuda.BUILD_DIR
    assert so.name.startswith("liblora_kernels_") and so.suffix == ".so"
    assert _cuda.library_path() == so
    monkeypatch.setattr(_cuda, "NVCC_FLAGS", _cuda.NVCC_FLAGS + ("-lineinfo",))
    assert _cuda.library_path() != so
    assert "--use_fast_math" not in _cuda.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build()
    # the failed build leaves no half-written library behind
    assert list(tmp_path.rglob("*.so")) == []


FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if {fail!r} and any(a.endswith({fail!r}) for a in args):
    sys.exit("nvcc: error in " + {fail!r})
with open(args[args.index("-o") + 1], "w") as f:
    f.write("object")
"""


def fake_nvcc(tmp_path, fail=""):
    log = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log),
                                     fail=fail))
    nvcc.chmod(0o755)
    return str(nvcc), log


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    nvcc, log = fake_nvcc(tmp_path)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "_nvcc", lambda: nvcc)
    so = _cuda.build()
    assert so.exists() and so.parent == tmp_path / "build"
    calls = [c.split() for c in log.read_text().splitlines()]
    compiles, link = calls[:-1], calls[-1]
    assert "channelize.cu" in _cuda.SOURCES
    assert sorted(c[-1].rsplit("/", 1)[-1] for c in compiles) == \
        sorted(_cuda.SOURCES)
    assert all("-c" in c and "-shared" not in c for c in compiles)
    assert "-shared" in link
    assert sorted(link[link.index("-o") + 2:]) == sorted(
        c[c.index("-o") + 1] for c in compiles)
    assert _cuda.build() == so  # built once per set of sources


def test_failed_compile_raises_with_its_output(monkeypatch, tmp_path):
    nvcc, _ = fake_nvcc(tmp_path, fail="channelize.cu")
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="error in channelize.cu"):
        _cuda.build()
    assert list((tmp_path / "build").rglob("*.so")) == []
    assert list((tmp_path / "build").rglob("*.o")) == []


@pytest.mark.parametrize("N", [32, 100, 8192])
def test_window_size_refused(N):
    with pytest.raises(ValueError, match="power-of-two"):
        _cuda.check_window_size(N)


def test_buffer_and_argument_checks():
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.check_buffer(torch.zeros((2, 64), dtype=torch.complex64), "x")
    with pytest.raises(ValueError, match="expected shape"):
        _cuda.on_device(np.zeros(3), torch.int32, "cpu", (4,), "t0")
    t = _cuda.on_device(np.arange(4), torch.int32, "cpu", (4,), "t0")
    assert t.dtype == torch.int32 and t.is_contiguous()
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _cuda.check(9, "lora_detect")
    _cuda.check(0, "lora_detect")


@pytest.mark.parametrize("N", [64, 1024, 4096])
def test_kernel_constants_are_the_plain_versions(N):
    up, down, tw, rot_scale, db_scale = _cuda.consts(N, torch.device("cpu"))
    assert torch.equal(up, chirp.dechirp_table(N, False, "cpu"))
    assert torch.equal(down, chirp.dechirp_table(N, True, "cpu"))
    assert tw.dtype == torch.complex64 and tw.shape == (N // 2,)
    np.testing.assert_array_equal(torch.view_as_real(tw).numpy(),
                                  tables.fft_twiddles_np(N))
    assert rot_scale == float(np.float32(-2 * math.pi / N))
    assert db_scale == float(np.float32(20 * np.log10(N)))


def _c_signatures():
    """{entry: [ctypes types]} read from the extern "C" declarations of the
    sources, so that the Python argtypes cannot drift from the C side (no
    compiler checks them: the library is loaded with ctypes)."""
    import ctypes
    import re

    kinds = {"void*": ctypes.c_void_p, "long long": ctypes.c_longlong,
             "int": ctypes.c_int, "float": ctypes.c_float}
    out = {}
    for name in _cuda.SOURCES:
        text = (_cuda.CSRC / name).read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            args = []
            for a in m.group(2).split(","):
                kind = " ".join(a.replace("const ", "").split()[:-1])
                args.append(kinds[kind])
            out[m.group(1)] = args
    return out


def test_sources_and_entry_points():
    assert "shift.cu" in _cuda.SOURCES and "lora_shift" in _cuda._ARGTYPES
    for name in _cuda.SOURCES + _cuda.HEADERS:
        assert (_cuda.CSRC / name).is_file(), name
    assert sorted(p.name for p in _cuda.CSRC.iterdir()) == sorted(
        _cuda.SOURCES + _cuda.HEADERS)


@pytest.mark.parametrize("entry", sorted(_cuda._ARGTYPES))
def test_argtypes_match_the_c_declarations(entry):
    sigs = _c_signatures()
    assert sorted(sigs) == sorted(_cuda._ARGTYPES)
    assert sigs[entry] == _cuda._ARGTYPES[entry], entry
