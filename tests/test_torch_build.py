"""The kernels' build and launch glue (lora_tpu_torch/ops/_cuda.py) on the
CPU: the library is named by its sources, a missing nvcc is reported, the
argument checks refuse what the kernels do not take, and the constants
the kernels receive are the plain version's."""

import dataclasses
import math
import sys

import numpy as np
import pytest
import torch

from lora_tpu_torch.ops import _cuda, chirp, tables

torch.set_num_threads(1)
CPU = torch.device("cpu")


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


def _leaves(obj) -> list:
    """The tensors of a result: a tensor, a dict, a dataclass, a tuple."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _leaves(v)]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in _leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _leaves(v)]
    assert obj is None, type(obj)
    return []


def _cpu_route(kernel: str):
    """(the entry point's result on CPU tensors, its plain version's)."""
    from lora_tpu_torch import LoRaConfig, api
    from lora_tpu_torch.models import decoder
    from lora_tpu_torch.ops import channelizer, cuda_channelize, cuda_demod
    from lora_tpu_torch.ops import cuda_detect, cuda_modulate, detect
    from lora_tpu_torch.ops import resample, shift

    g = torch.Generator().manual_seed(7)
    iq = lambda *shape: torch.randn(shape, dtype=torch.complex64, generator=g)
    ints = lambda hi, *shape: torch.randint(0, hi, shape, generator=g)
    N, mtu = 64, 4
    if kernel == "detect":
        x, fe = iq(2, 3, N), torch.rand((2, 3), generator=g)
        return (cuda_detect.dechirp_detect(x, True, fe),
                detect.dechirp_detect(x, True, fe, want_f_index=True))
    if kernel in ("track", "payload"):
        x = iq(2, 16 * N)
        t0, fine = ints(2 * N, 2), torch.rand(2, generator=g)
        if kernel == "track":
            return (cuda_demod.track(x, t0, 0x12, 3.0, N),
                    cuda_demod.track_plain(x, t0, 0x12, 3.0, N))
        return (cuda_demod.payload_detect(x, t0, fine, mtu, N, True),
                cuda_demod.payload_detect_plain(x, t0, fine, mtu, N, True))
    if kernel == "channelize":
        K, L, M = 16, 8, 48
        x, state = iq(2, K * M), iq(2, L * K - 1)
        return (cuda_channelize.filterbank(x, K, L, state),
                cuda_channelize.filterbank_plain(
                    channelizer.prepended(x, state, L * K - 1), K, L, M))
    if kernel == "shift":
        rows, r = iq(2, mtu + 1, N), ints(N, 2)
        return (shift.shift_windows(rows, r, mtu),
                shift.shift_windows_plain(rows, r, mtu))
    if kernel == "modulate":
        args = (ints(N, 3, 17), iq(100), 5, N, 2, 1, 0.5)
        return (cuda_modulate.frame(*args), cuda_modulate.frame_plain(*args))
    if kernel == "decode":
        cfg = LoRaConfig(sf=7, cr="4/6")
        sym = api.encode(ints(256, 3, 12).to(torch.uint8), cfg, device="cpu")
        return (decoder.decode(sym, cfg),
                decoder.decode_plain(sym, cfg, sym.shape[-1]))
    x = iq(3, 4000)
    M = int((4000 - resample._taps_eff(1.6)) / 1.6)
    return (resample.resample(x, 1.6),
            resample._apply(x, resample.plan_on(0, M, 1.6, 0, CPU).table, 1.6))


@pytest.mark.parametrize("kernel", ["detect", "track", "payload",
                                    "channelize", "shift", "modulate",
                                    "decode", "resample"])
def test_the_cpu_route_is_the_plain_version_and_loads_no_kernel(
        kernel, monkeypatch):
    """A CPU tensor takes each kernel's plain version at its wrapper (kernels
    A to F) or at the entry point that picks the route (decode for kernel G,
    resample for kernel R, whose wrappers take only CUDA tensors), and never
    loads the kernels' library."""
    def refuse():
        raise AssertionError("the CPU route loaded the kernels' library")

    monkeypatch.setattr(_cuda, "library", refuse)
    got, want = _cpu_route(kernel)
    got, want = _leaves(got), _leaves(want)
    assert got and len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device == CPU and torch.equal(a, b)
