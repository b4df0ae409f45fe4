"""The kernels' build and launch glue (lora_tpu_torch/ops/_cuda.py) on the
CPU: the library is named by its sources, a missing nvcc is reported, the
argument checks refuse what the kernels do not take, and the constants
the kernels receive are the plain version's."""

import math

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
    assert torch.equal(up, chirp.dechirp_table(N, False))
    assert torch.equal(down, chirp.dechirp_table(N, True))
    assert tw.dtype == torch.complex64 and tw.shape == (N // 2,)
    np.testing.assert_array_equal(torch.view_as_real(tw).numpy(),
                                  tables.fft_twiddles_np(N))
    assert rot_scale == float(np.float32(-2 * math.pi / N))
    assert db_scale == float(np.float32(20 * np.log10(N)))
