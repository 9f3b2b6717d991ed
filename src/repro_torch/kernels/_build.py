"""nvcc at first use: one CUDA source -> one shared library with a plain C
interface, loaded by the caller with ``ctypes``.

The library lives in ``build/repro_torch_kernels/`` at the repository
root and is named by the library name and a hash of the source and the
flags (``lib<name>_<hash16>.so``), so an edit rebuilds it and a second
process finds the first one's build. ptxas's report (registers, shared
memory and spills of each kernel, ``-Xptxas -v``) is kept beside it
(``.log``).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> wall seconds of this process's nvcc build of it (absent:
# the library was already built)
build_seconds: dict = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def library_path(source: Path, name: str) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def tool(name: str) -> str:
    """A CUDA toolkit program beside nvcc (e.g. ``cuobjdump``)."""
    return str(Path(nvcc()).with_name(name))


def build(source: Path, name: str) -> Path:
    """Compile ``source`` unless its library exists. Raises with nvcc's
    output when the build fails."""
    path = library_path(source, name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tic = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{source}:\n{proc.stdout}{proc.stderr}")
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, path)           # atomic: concurrent builders agree
    build_seconds[name] = time.perf_counter() - tic
    return path
