"""The port imports no jax (the machines with the card have none) and nothing
of the JAX package lora_tpu, not even its jax-free modules: it keeps its own
copies.  Checked in a fresh interpreter: tests/conftest.py imports jax into
this one."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import lora_tpu_torch
from lora_tpu_torch import api
for m in pkgutil.walk_packages(lora_tpu_torch.__path__, "lora_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
for name in ("ops.channelizer", "ops.cuda_channelize", "roadmap", "config",
             "ops._bitref", "ops.shift", "ops.cuda_modulate", "models.softdec",
             "runtime.stream",
             "runtime.slab", "runtime.iqio", "hw.capture", "cli",
             "utils.debugcheck", "ops.resample", "ops.cuda_resample",
             "ops.dcblock",
             "parallel.mesh", "parallel.halo", "parallel.channelize",
             "parallel.dispatch", "parallel.multihost", "parallel.comm",
             "parallel.dryrun", "benchmarks", "utils.trace",
             "tools.bench_sensitivity", "tools.run_sensitivity_campaign",
             "tools.bench_e2e", "tools.bench_soft", "tools.bench_decode",
             "tools.bench_stream", "examples.wideband_rx",
             "examples.lora_simulation", "examples.modulation_explained",
             "examples.lora_sdr_relay", "examples.rx_rn2483", "utils.jit"):
    assert "lora_tpu_torch." + name in sys.modules, name
# the radio examples' SDR module and plotting load only when they run
assert "SoapySDR" not in sys.modules and "matplotlib" not in sys.modules
# the native ingest library builds under build/, never in the package
from lora_tpu_torch.ops import _cuda
from lora_tpu_torch.runtime import iqio
assert iqio.get_lib() is not None
assert iqio.library_path().parent == _cuda.BUILD_DIR
assert iqio.library_path().exists()
assert not list((_cuda.CSRC.parent / "runtime" / "native").glob("*.so"))
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax."))
assert not bad, bad
# mind the prefix: lora_tpu_torch is the port, lora_tpu the JAX package
bad = sorted(k for k in sys.modules
             if k == "lora_tpu" or k.startswith("lora_tpu."))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "NO_JAX_OK" in out.stdout


def test_port_sources_name_no_jax_package_import():
    """No module of the port, and not chip_smoke.py, has an import statement
    that names lora_tpu or loads one of its files by path."""
    import ast

    files = sorted((REPO / "lora_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    # the tools' and examples' twins are among the sources walked
    walked = {p.relative_to(REPO).parent.as_posix() for p in files}
    assert {"lora_tpu_torch/tools", "lora_tpu_torch/examples"} <= walked
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("lora_tpu", "jax", "jaxlib"), (path, name)
            # loading a file of the JAX package by path
            if isinstance(node, ast.Attribute):
                assert node.attr != "spec_from_file_location", path
