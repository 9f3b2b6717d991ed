"""Wrappers for the FedDPC server-step kernels (csrc/feddpc_project.cu).

``feddpc_dots`` is the reduction pass over the flat (K, N) stack of
client deltas; the four folds compute Δ_t and w' from it:

  feddpc_batched_epilogue          synchronous round, f32 deltas
  feddpc_buffer_fold               buffered-async round (staleness weights)
  feddpc_dequant_batched_epilogue  synchronous round, int8/bf16 payload
  feddpc_dequant_buffer_fold       buffered-async round, int8/bf16 payload

``feddpc_guard_dots`` is the update guard's reduction pass (the dots on
the stack with non-finite entries zeroed, plus their count), and
``feddpc_fused_epilogue`` one client's epilogue, scale·(d − coef·p), the
second pass of ``project_and_scale_flat`` and of
``core/projection.project_and_scale``.

Each wrapper checks device, dtype, shape and contiguity, then

  * for CUDA tensors launches its kernel on the current stream (or
    raises — there is no fallback), and adds one to its ``launches``
    count, only there;
  * for CPU tensors calls the plain version in ``ref.py``;
  * for meta tensors (``feddpc_dots`` and ``feddpc_batched_epilogue``,
    the synchronous round's two) returns meta outputs and records one
    launch's cost (kernels.meta_cost), for the dry-run.

The kernels are compiled at first use with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes`` (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import projection as proj
from repro_torch.kernels import _build, meta_cost
from repro_torch.kernels.feddpc_project import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "feddpc_project.cu"
LIBRARY = "feddpc_project"

_lib = None           # the loaded library, once per process
MAX_LEAVES = 6143     # the dequant folds keep L+1 offsets in 48 KB of smem
QTYPES = {torch.int8: 0, torch.bfloat16: 1}   # payload dtype -> kernel code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # epilogue d dtype -> code
# device copies of leaf offsets, keyed by (device, offsets); a handful of
# layouts per process, so the copy (which waits for the stream) happens
# once per layout and not once per round
_device_offsets_cache = {}


def build() -> Path:
    """Compile the kernels unless this source's library exists."""
    return _build.build(SOURCE, LIBRARY)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        lib.feddpc_num_blocks.argtypes = [i64]
        lib.feddpc_num_blocks.restype = i64
        for fn in (lib.feddpc_dots, lib.feddpc_guard_dots):
            fn.argtypes = [vp, vp, vp, i64, i64, vp]
            fn.restype = ctypes.c_int
        lib.feddpc_fused_epilogue.argtypes = [vp, ctypes.c_int, vp, vp, vp,
                                              vp, i64, vp]
        lib.feddpc_fused_epilogue.restype = ctypes.c_int
        lib.feddpc_batched_epilogue.argtypes = [vp, vp, vp, vp, vp, f32,
                                                vp, vp, i64, i64, vp]
        lib.feddpc_buffer_fold.argtypes = [vp, vp, vp, vp, vp, vp, f32, vp,
                                           vp, i64, i64, vp]
        lib.feddpc_dequant_batched_epilogue.argtypes = [
            vp, ctypes.c_int, vp, vp, vp, i64, vp, vp, vp, vp, f32, vp, vp,
            i64, i64, vp]
        lib.feddpc_dequant_buffer_fold.argtypes = [
            vp, ctypes.c_int, vp, vp, vp, i64, vp, vp, vp, vp, vp, f32, vp,
            vp, i64, i64, vp]
        for fn in (lib.feddpc_batched_epilogue, lib.feddpc_buffer_fold,
                   lib.feddpc_dequant_batched_epilogue,
                   lib.feddpc_dequant_buffer_fold):
            fn.restype = ctypes.c_int
        lib.feddpc_error_string.argtypes = [ctypes.c_int]
        lib.feddpc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_launch(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.feddpc_error_string(err).decode()})")


def _check(name: str, d: torch.Tensor, dtypes, meta: bool = False,
           **named: torch.Tensor):
    """d (K, N) of one of ``dtypes`` plus named f32 tensors whose shape
    follows from the name: 'p', 'w' (N,); 'coefs', 'scales', 'wgts'
    (K,); 'qscale', 'qzero' (K, L) with L from qscale. All contiguous,
    on one device (CPU or CUDA, or meta where ``meta``)."""
    if d.dim() != 2 or d.shape[0] < 1 or d.shape[1] < 1:
        raise ValueError(f"{name}: d must be (K, N) with K, N >= 1, got "
                         f"{tuple(d.shape)}")
    k, n = d.shape
    if d.device.type not in (("cpu", "cuda", "meta") if meta
                             else ("cpu", "cuda")):
        raise ValueError(f"{name}: tensors on {d.device} are not supported")
    if d.dtype not in dtypes:
        raise TypeError(f"{name}: d must be one of {list(dtypes)}, got "
                        f"{d.dtype}")
    if not d.is_contiguous():
        raise ValueError(f"{name}: d must be contiguous")
    nleaves = named["qscale"].shape[-1] if "qscale" in named else None
    for key, t in named.items():
        want = {"p": (n,), "w": (n,), "qscale": (k, nleaves),
                "qzero": (k, nleaves)}.get(key, (k,))
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} must be {want}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if t.device != d.device:
            raise ValueError(f"{name}: {key} is on {t.device}, d on "
                             f"{d.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_offsets(name: str, offsets: torch.Tensor, n: int, nleaves: int):
    """Leaf offsets are host-side layout metadata: a CPU int64 (L+1,)
    tensor, 0 first, N last, strictly increasing."""
    if (offsets.device.type != "cpu" or offsets.dtype != torch.int64
            or tuple(offsets.shape) != (nleaves + 1,)):
        raise ValueError(f"{name}: leaf_offsets must be a CPU int64 tensor "
                         f"of shape ({nleaves + 1},), got {offsets.dtype} "
                         f"{tuple(offsets.shape)} on {offsets.device}")
    if nleaves > MAX_LEAVES:
        raise ValueError(f"{name}: {nleaves} leaves; the kernels take at "
                         f"most {MAX_LEAVES}")
    if (int(offsets[0]) != 0 or int(offsets[-1]) != n
            or not bool((offsets[1:] > offsets[:-1]).all())):
        raise ValueError(f"{name}: leaf_offsets must run from 0 to N={n}, "
                         "strictly increasing")


def device_offsets(offsets: torch.Tensor, device: torch.device):
    key = (str(device), offsets.numpy().tobytes())
    out = _device_offsets_cache.get(key)
    if out is None:
        if len(_device_offsets_cache) >= 16:
            _device_offsets_cache.clear()
        out = _device_offsets_cache[key] = offsets.to(device)
    return out


def dots_num_blocks(n: int) -> int:
    """G, the number of column blocks (and partials per row) of the
    dots kernel for rows of n elements."""
    return int(_load().feddpc_num_blocks(n))


def feddpc_dots(d: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Reduction pass: d (K, N), p (N,) -> (K, 3) f32 =
    [<d_j,p>, <d_j,d_j>, <p,p>] per client row j, all rows in one launch.
    The kernel writes per-block partials (K, G, 3); one ``torch.sum``
    over G finishes them."""
    _check("feddpc_dots", d, (torch.float32,), meta=True, p=p)
    if d.device.type == "cpu":
        return ref.dots_ref(d, p)
    k, n = d.shape
    if d.device.type == "meta":
        # the bound's count: d and p read once, the (K, 3) result written
        # once (the per-block partials, a library query, left out); 4
        # FLOPs an element of d, 2 an element of p
        meta_cost("feddpc_dots", 4 * k * n + 2 * n,
                  4 * ((k + 1) * n + 3 * k))
        return torch.empty((k, 3), dtype=torch.float32, device=d.device)
    lib = _load()
    partials = torch.empty((k, dots_num_blocks(n), 3),
                           device=d.device, dtype=torch.float32)
    with torch.cuda.device(d.device):
        err = lib.feddpc_dots(d.data_ptr(), p.data_ptr(),
                              partials.data_ptr(), k, n,
                              torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, err, "feddpc_dots")
    feddpc_dots.launches += 1
    return torch.sum(partials, dim=1)


def feddpc_guard_dots(d: torch.Tensor, p=None) -> torch.Tensor:
    """The update guard's reduction pass: d (K, N) f32, p (N,) f32 or
    None -> (K, 4) f32 = [<d~_j,p>, <d~_j,d~_j>, <p,p>, nonfinite(d_j)]
    per row j, where d~ is d with its NaN/Inf entries zeroed. Without p
    (the guard's route) p is not read and columns 0 and 2 are 0. The
    count is exact for N < 2^24."""
    named = {} if p is None else {"p": p}
    _check("feddpc_guard_dots", d, (torch.float32,), **named)
    if d.device.type == "cpu":
        return ref.guard_dots_ref(d, p)
    lib = _load()
    k, n = d.shape
    partials = torch.empty((k, dots_num_blocks(n), 4),
                           device=d.device, dtype=torch.float32)
    with torch.cuda.device(d.device):
        err = lib.feddpc_guard_dots(
            d.data_ptr(), None if p is None else p.data_ptr(),
            partials.data_ptr(), k, n,
            torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, err, "feddpc_guard_dots")
    feddpc_guard_dots.launches += 1
    return torch.sum(partials, dim=1)


def feddpc_fused_epilogue(d: torch.Tensor, p: torch.Tensor,
                          coef: torch.Tensor, scale: torch.Tensor
                          ) -> torch.Tensor:
    """One client's epilogue: d (N,) f32 or bf16, p (N,) f32, coef and
    scale one-element f32 tensors on d's device (from the reduction
    pass, so no host sync) -> new (N,) tensor of d's dtype,
    scale * (d - coef * p) computed in f32."""
    name = "feddpc_fused_epilogue"
    if d.dim() != 1 or d.shape[0] < 1:
        raise ValueError(f"{name}: d must be (N,) with N >= 1, got "
                         f"{tuple(d.shape)}")
    _check(name, d[None], tuple(DTYPES), p=p)
    for key, t in (("coef", coef), ("scale", scale)):
        if not isinstance(t, torch.Tensor) or t.numel() != 1 or t.dim() > 1:
            raise ValueError(f"{name}: {key} must be a tensor of shape () "
                             "or (1,)")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if t.device != d.device:
            raise ValueError(f"{name}: {key} is on {t.device}, d on "
                             f"{d.device}")
    if d.device.type == "cpu":
        return ref.epilogue_ref(d, p, coef, scale)
    lib = _load()
    out = torch.empty_like(d)
    with torch.cuda.device(d.device):
        err = lib.feddpc_fused_epilogue(
            d.data_ptr(), DTYPES[d.dtype], p.data_ptr(), coef.data_ptr(),
            scale.data_ptr(), out.data_ptr(), d.shape[0],
            torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, err, name)
    feddpc_fused_epilogue.launches += 1
    return out


def project_and_scale_flat(d: torch.Tensor, p: torch.Tensor,
                           lam: float = 1.0) -> torch.Tensor:
    """FedDPC's whole per-client modification of one flat delta d (N,)
    (f32 or bf16) against p = Δ_prev (N,) f32, in two passes: the dots
    (``feddpc_dots``), the scalars on the device, then
    ``feddpc_fused_epilogue``. Returns scale·(d − coef·p) in d's dtype."""
    df = d if d.dtype == torch.float32 else d.float()
    dots = feddpc_dots(df.reshape(1, -1), p)
    coef, scale, _ = proj.scalars_from_dots(dots[:, 0], dots[:, 1],
                                            dots[:, 2], lam)
    return feddpc_fused_epilogue(d, p, coef, scale)


def _fold(name: str, d: torch.Tensor, p: torch.Tensor, w: torch.Tensor,
          coefs: torch.Tensor, scales: torch.Tensor, wgts, eta_g: float,
          qscale=None, qzero=None, leaf_offsets=None):
    """Launch the fold whose C entry point is ``name`` on the card;
    returns new (new_w, delta_t)."""
    lib = _load()
    k, n = d.shape
    new_w = torch.empty_like(w)
    dt = torch.empty_like(p)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    tail = (p.data_ptr(), w.data_ptr(), coefs.data_ptr(), scales.data_ptr(),
            *(() if wgts is None else (wgts.data_ptr(),)), float(eta_g),
            new_w.data_ptr(), dt.data_ptr(), k, n, stream)
    with torch.cuda.device(d.device):
        if qscale is None:
            err = getattr(lib, name)(d.data_ptr(), *tail)
        else:
            offs = device_offsets(leaf_offsets, d.device)
            err = getattr(lib, name)(
                d.data_ptr(), QTYPES[d.dtype], qscale.data_ptr(),
                qzero.data_ptr(), offs.data_ptr(), qscale.shape[1], *tail)
    _check_launch(lib, err, name)
    return new_w, dt


def feddpc_batched_epilogue(d: torch.Tensor, p: torch.Tensor,
                            w: torch.Tensor, coefs: torch.Tensor,
                            scales: torch.Tensor, eta_g: float):
    """Epilogue pass: d (K, N), p/w (N,), coefs/scales (K,) (device
    tensors, so no host sync between the passes), eta_g a float ->
    (new_w, delta_t), both new (N,) f32 tensors:
    delta_t = mean_j scale_j (d_j - coef_j p), new_w = w - eta_g delta_t.
    f32 w only."""
    _check("feddpc_batched_epilogue", d, (torch.float32,), meta=True, p=p,
           w=w, coefs=coefs, scales=scales)
    if d.device.type == "cpu":
        return ref.batched_epilogue_ref(d, p, w, coefs, scales, eta_g)
    if d.device.type == "meta":
        # the bound's count: d, p, w, coefs and scales read once, w' and
        # delta_t written once; 4 FLOPs an element of d, 3 a column
        k, n = d.shape
        meta_cost("feddpc_batched_epilogue", 4 * k * n + 3 * n,
                  4 * (k * n + 4 * n + 2 * k))
        return torch.empty_like(w), torch.empty((n,), dtype=torch.float32,
                                                device=d.device)
    out = _fold("feddpc_batched_epilogue", d, p, w, coefs, scales, None,
                eta_g)
    feddpc_batched_epilogue.launches += 1
    return out


def feddpc_buffer_fold(d: torch.Tensor, p: torch.Tensor, w: torch.Tensor,
                       coefs: torch.Tensor, scales: torch.Tensor,
                       wgts: torch.Tensor, eta_g: float):
    """Buffered-async fold: d (B, N) arrivals, wgts (B,) staleness
    discounts -> (new_w, delta_t) with
    delta_t = mean_j wgt_j scale_j (d_j - coef_j p)."""
    _check("feddpc_buffer_fold", d, (torch.float32,), p=p, w=w, coefs=coefs,
           scales=scales, wgts=wgts)
    if d.device.type == "cpu":
        return ref.buffer_fold_ref(d, p, w, coefs, scales, wgts, eta_g)
    out = _fold("feddpc_buffer_fold", d, p, w, coefs, scales, wgts, eta_g)
    feddpc_buffer_fold.launches += 1
    return out


def feddpc_dequant_batched_epilogue(q: torch.Tensor, qscale: torch.Tensor,
                                    qzero: torch.Tensor,
                                    leaf_offsets: torch.Tensor,
                                    p: torch.Tensor, w: torch.Tensor,
                                    coefs: torch.Tensor,
                                    scales: torch.Tensor, eta_g: float):
    """The batched epilogue over the codec's payload: q (K, N) int8 or
    bf16, qscale/qzero (K, L) f32, leaf_offsets (L+1,) CPU int64;
    d_j = q_j * qscale[j, leaf] + qzero[j, leaf] is formed in registers."""
    name = "feddpc_dequant_batched_epilogue"
    _check(name, q, tuple(QTYPES), qscale=qscale, qzero=qzero, p=p, w=w,
           coefs=coefs, scales=scales)
    _check_offsets(name, leaf_offsets, q.shape[1], qscale.shape[1])
    if q.device.type == "cpu":
        return ref.dequant_batched_epilogue_ref(q, qscale, qzero,
                                                leaf_offsets, p, w, coefs,
                                                scales, eta_g)
    out = _fold(name, q, p, w, coefs, scales, None, eta_g, qscale, qzero,
                leaf_offsets)
    feddpc_dequant_batched_epilogue.launches += 1
    return out


def feddpc_dequant_buffer_fold(q: torch.Tensor, qscale: torch.Tensor,
                               qzero: torch.Tensor,
                               leaf_offsets: torch.Tensor, p: torch.Tensor,
                               w: torch.Tensor, coefs: torch.Tensor,
                               scales: torch.Tensor, wgts: torch.Tensor,
                               eta_g: float):
    """The buffered-async fold over a quantized arrival buffer: q (B, N),
    qscale/qzero (B, L), wgts (B,); as ``feddpc_dequant_batched_epilogue``
    otherwise."""
    name = "feddpc_dequant_buffer_fold"
    _check(name, q, tuple(QTYPES), qscale=qscale, qzero=qzero, p=p, w=w,
           coefs=coefs, scales=scales, wgts=wgts)
    _check_offsets(name, leaf_offsets, q.shape[1], qscale.shape[1])
    if q.device.type == "cpu":
        return ref.dequant_buffer_fold_ref(q, qscale, qzero, leaf_offsets,
                                           p, w, coefs, scales, wgts, eta_g)
    out = _fold(name, q, p, w, coefs, scales, wgts, eta_g, qscale, qzero,
                leaf_offsets)
    feddpc_dequant_buffer_fold.launches += 1
    return out


KERNELS = (feddpc_dots, feddpc_batched_epilogue, feddpc_buffer_fold,
           feddpc_dequant_batched_epilogue, feddpc_dequant_buffer_fold,
           feddpc_guard_dots, feddpc_fused_epilogue)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0
