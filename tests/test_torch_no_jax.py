"""The port imports no jax (the machines with the card have none).  Checked in
a fresh interpreter: tests/conftest.py imports jax into this one."""

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
for name in ("ops.channelizer", "ops.cuda_channelize", "roadmap"):
    assert "lora_tpu_torch." + name in sys.modules, name
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax."))
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
