"""repro_torch and chip_smoke.py import neither JAX nor anything of the
reference package, and chip_smoke.py refuses to run without a card."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

HYGIENE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke            # as a module: main() does not run
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             or m.startswith("jax"))
print(len(names), "modules")
assert not bad, bad
for must in ("repro_torch.kernels.feddpc_project.ops",
             "repro_torch.kernels.flash_attention.ops",
             "repro_torch.kernels.ssm_scan.ops",
             "repro_torch.models.ssm",
             "repro_torch.launch.serve"):
    assert must in names, (must, names)
print("chip_smoke.main() ->", chip_smoke.main())   # CUDA is hidden
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def hygiene_run():
    """One fresh interpreter: import every module of the port and
    chip_smoke, then call chip_smoke.main() with the card hidden."""
    return subprocess.run(
        [sys.executable, "-c", HYGIENE], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env=_env(PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
                 CUDA_VISIBLE_DEVICES=""))


def test_port_imports_no_jax_and_no_reference(hygiene_run):
    assert hygiene_run.returncode == 0, (hygiene_run.stdout
                                         + hygiene_run.stderr)


def test_chip_smoke_fails_without_a_card(hygiene_run):
    assert "chip_smoke.main() -> 1" in hygiene_run.stdout, (
        hygiene_run.stdout + hygiene_run.stderr)
    assert '"ok"' not in hygiene_run.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env=_env(CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
