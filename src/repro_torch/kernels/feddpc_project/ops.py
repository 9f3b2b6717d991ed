"""Wrappers for the FedDPC server-step kernels (csrc/feddpc_project.cu).

``feddpc_dots`` is the reduction pass and ``feddpc_batched_epilogue`` the
whole-cohort epilogue, both over the flat (K, N) stack of client deltas.
Each wrapper checks device, dtype, shape and contiguity, then

  * for CUDA tensors launches its kernel on the current stream (or
    raises — there is no fallback), and adds one to its ``launches``
    count, only there;
  * for CPU tensors calls the plain version in ``ref.py``.

The kernels are compiled at first use with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``. The library lives in
``build/repro_torch_kernels/`` at the repository root and is named by a
hash of the source and the flags, so an edit rebuilds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels.feddpc_project import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "feddpc_project.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None           # the loaded library, once per process
build_seconds = None  # wall time of this process's nvcc build (None: cached)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the FedDPC "
                           "kernels are built from source at first use")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfeddpc_project_{digest[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this source's library exists. Raises
    with nvcc's output when the build fails."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tic = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)           # atomic: concurrent builders agree
    build_seconds = time.perf_counter() - tic
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.feddpc_num_blocks.argtypes = [i64]
        lib.feddpc_num_blocks.restype = i64
        lib.feddpc_dots.argtypes = [vp, vp, vp, i64, i64, vp]
        lib.feddpc_dots.restype = ctypes.c_int
        lib.feddpc_batched_epilogue.argtypes = [vp, vp, vp, vp, vp,
                                                ctypes.c_float, vp, vp,
                                                i64, i64, vp]
        lib.feddpc_batched_epilogue.restype = ctypes.c_int
        lib.feddpc_error_string.argtypes = [ctypes.c_int]
        lib.feddpc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_launch(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.feddpc_error_string(err).decode()})")


def _check(name: str, d: torch.Tensor, **vectors: torch.Tensor):
    """d (K, N) plus named vectors whose length is N ('p', 'w') or K
    ('coefs', 'scales'): f32, contiguous, one device (CPU or CUDA)."""
    if d.dim() != 2 or d.shape[0] < 1 or d.shape[1] < 1:
        raise ValueError(f"{name}: d must be (K, N) with K, N >= 1, got "
                         f"{tuple(d.shape)}")
    k, n = d.shape
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {d.device} are not supported")
    for key, t in (("d", d), *vectors.items()):
        want = (k,) if key in ("coefs", "scales") else (n,)
        if key != "d" and tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} must be {want}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if t.device != d.device:
            raise ValueError(f"{name}: {key} is on {t.device}, d on "
                             f"{d.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def dots_num_blocks(n: int) -> int:
    """G, the number of column blocks (and partials per row) of the
    dots kernel for rows of n elements."""
    return int(_load().feddpc_num_blocks(n))


def feddpc_dots(d: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Reduction pass: d (K, N), p (N,) -> (K, 3) f32 =
    [<d_j,p>, <d_j,d_j>, <p,p>] per client row j, all rows in one launch.
    The kernel writes per-block partials (K, G, 3); one ``torch.sum``
    over G finishes them."""
    _check("feddpc_dots", d, p=p)
    if d.device.type == "cpu":
        return ref.dots_ref(d, p)
    lib = _load()
    k, n = d.shape
    partials = torch.empty((k, dots_num_blocks(n), 3),
                           device=d.device, dtype=torch.float32)
    with torch.cuda.device(d.device):
        err = lib.feddpc_dots(d.data_ptr(), p.data_ptr(),
                              partials.data_ptr(), k, n,
                              torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, err, "feddpc_dots")
    feddpc_dots.launches += 1
    return torch.sum(partials, dim=1)


def feddpc_batched_epilogue(d: torch.Tensor, p: torch.Tensor,
                            w: torch.Tensor, coefs: torch.Tensor,
                            scales: torch.Tensor, eta_g: float):
    """Epilogue pass: d (K, N), p/w (N,), coefs/scales (K,) (device
    tensors, so no host sync between the passes), eta_g a float ->
    (new_w, delta_t), both new (N,) f32 tensors:
    delta_t = mean_j scale_j (d_j - coef_j p), new_w = w - eta_g delta_t.
    f32 w only."""
    _check("feddpc_batched_epilogue", d, p=p, w=w, coefs=coefs,
           scales=scales)
    if d.device.type == "cpu":
        return ref.batched_epilogue_ref(d, p, w, coefs, scales, eta_g)
    lib = _load()
    k, n = d.shape
    new_w = torch.empty_like(w)
    dt = torch.empty_like(p)
    with torch.cuda.device(d.device):
        err = lib.feddpc_batched_epilogue(
            d.data_ptr(), p.data_ptr(), w.data_ptr(), coefs.data_ptr(),
            scales.data_ptr(), float(eta_g), new_w.data_ptr(),
            dt.data_ptr(), k, n, torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, err, "feddpc_batched_epilogue")
    feddpc_batched_epilogue.launches += 1
    return new_w, dt


feddpc_dots.launches = 0
feddpc_batched_epilogue.launches = 0
KERNELS = (feddpc_dots, feddpc_batched_epilogue)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0
