"""Wrapper for the flash-attention kernel (csrc/flash_attention.cu), with
the contract of repro/kernels/flash_attention/ops.py: q (B, Sq, H, D),
k/v (B, Sk, KV, D), positions (B, Sq) / (B, Sk) int (-1 = an empty cache
slot), ``window`` (0 = full) and ``soft_cap`` (0 = none).

``flash_attention`` checks shapes, dtypes and devices, refuses (with a
ValueError naming the training route) any input that requires grad or is
wrapped by a ``torch.func`` transform — the kernel has no backward, nor
has the reference's — then

  * for CUDA tensors launches the kernel on the current stream (or
    raises — there is no fallback) and adds one to its ``launches``
    count, only there;
  * for CPU tensors calls the plain version, ``ref.attention_ref``.

``plan`` picks the kernel's body (its route) from the shapes. A call with
at most 16 rows a (batch, KV head) — a row is a (query, group head) pair,
so decode — splits the keys into chunks over the grid and merges the
chunks' partials in the same launch (its plain counterpart is
``ref.attention_split_ref``): on tensor cores for bf16 with D in
TENSOR_CORE_DIMS (``split_decode_mma``), else on CUDA cores
(``split_decode``). A longer call takes the tensor cores for bf16 with D
in TENSOR_CORE_DIMS (``mma_bf16``), else CUDA cores (``fma``). The
tensor-core bodies are compiled for each of those exact head dims. The
split routes need f32 scratch for the chunks' partials and one arrival
counter per (batch, KV head): both are kept here per device and stream
(calls on one stream run one after another, and the kernel leaves the
counters at 0), so a decode call allocates nothing but its output.

There is no padding path: the kernel masks ragged tails itself. It is
compiled at first use with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes`` (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build, refuse_training
from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
LIBRARY = "flash_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # q/k/v dtype -> code
MAX_HEAD_DIM = 256
# bf16 head dims with mma bodies (192: MLA's qk_nope + qk_rope)
TENSOR_CORE_DIMS = (32, 64, 128, 192, 256)
# the kernel's bodies, by route code
ROUTES = ("fma", "mma_bf16", "split_decode", "split_decode_mma")
SPLIT_ROWS = 16       # rows a (batch, KV head) up to which decode splits
MAX_SPLITS = 256      # chunks a (batch, KV head): the merge's weights
TRAINING_ROUTE = ("the plain attention (models.transformer.loss_fn, or "
                  "attention.sdpa(impl='plain'))")

_lib = None           # the loaded library, once per process
_scratch = {}         # (device index, stream) -> (f32 partials, counters)


def build() -> Path:
    """Compile the kernel unless this source's library exists."""
    return _build.build(SOURCE, LIBRARY)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32,
                                            i32, i32, i32, i32, i32, i32,
                                            ctypes.c_float, i32, i32, i32,
                                            vp, vp, vp]
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v, q_pos, k_pos):
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q must be (B, Sq, H, D) and k, v "
                         f"(B, Sk, KV, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, kv, dk = k.shape
    if k.shape[0] != b or dk != d or kv < 1 or h % kv:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not agree (same B and D, "
                         "H a multiple of KV)")
    if min(b, sq, sk, d) < 1:
        raise ValueError(f"{name}: empty input {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if tuple(q_pos.shape) != (b, sq) or tuple(k_pos.shape) != (b, sk):
        raise ValueError(f"{name}: positions must be ({b}, {sq}) and "
                         f"({b}, {sk}), got {tuple(q_pos.shape)}, "
                         f"{tuple(k_pos.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one of {list(DTYPES)},"
                        f" got {q.dtype}, {k.dtype}, {v.dtype}")
    for pos in (q_pos, k_pos):
        if pos.dtype.is_floating_point or pos.dtype == torch.bool:
            raise TypeError(f"{name}: positions must be integers, got "
                            f"{pos.dtype}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {q.device} are not supported")
    for t in (k, v, q_pos, k_pos):
        if t.device != q.device:
            raise ValueError(f"{name}: inputs on {t.device} and {q.device}")


def plan(q_shape, k_shape, dtype, num_sms: int):
    """(route, chunk, splits) for q of ``q_shape`` and k of ``k_shape`` in
    ``dtype`` on a card of ``num_sms`` SMs. A split decode when a (batch,
    KV head) has at most SPLIT_ROWS rows: its chunk 64 keys — 128 in bf16
    when that still gives 4 blocks an SM — and longer only past MAX_SPLITS
    chunks. Tensor cores for bf16 with D in TENSOR_CORE_DIMS. Chunk and
    splits are 0 for the other routes."""
    b, sq, h, d = q_shape
    sk, kv = k_shape[1], k_shape[2]
    tensor_cores = dtype == torch.bfloat16 and d in TENSOR_CORE_DIMS
    if sq * (h // kv) <= SPLIT_ROWS:
        chunk = 64
        if (dtype == torch.bfloat16
                and math.ceil(sk / 128) * b * kv >= 4 * num_sms):
            chunk = 128
        chunk = max(chunk, 32 * math.ceil(sk / (32 * MAX_SPLITS)))
        route = "split_decode_mma" if tensor_cores else "split_decode"
        return route, chunk, math.ceil(sk / chunk)
    return ("mma_bf16" if tensor_cores else "fma"), 0, 0


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_plan = functools.lru_cache(maxsize=1024)(plan)


def _split_scratch(index: int, stream: int, n_part: int, n_count: int):
    """f32 scratch of at least n_part and n_count int32 counters at 0 for
    ``stream`` of device ``index``; grown, never shrunk."""
    part, counters = _scratch.get((index, stream), (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32,
                           device=torch.device("cuda", index))
    if counters is None or counters.numel() < n_count:
        counters = torch.zeros(max(n_count, 256), dtype=torch.int32,
                               device=torch.device("cuda", index))
    _scratch[(index, stream)] = (part, counters)
    return part, counters


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                    window: int = 0, soft_cap: float = 0.0) -> torch.Tensor:
    """(B, Sq, H, D) attention output in q's dtype (f32 or bf16); query
    head h reads KV head h // (H / KV)."""
    _check(q, k, v, q_pos, k_pos)
    refuse_training("flash_attention", TRAINING_ROUTE, q, k, v)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, q_pos, k_pos, window=window,
                                 soft_cap=soft_cap)
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if d % 4 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the kernel takes D a multiple "
                         f"of 4 up to {MAX_HEAD_DIM}, got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: q, k and v must start on a "
                             "16-byte boundary")
    index = q.device.index
    route, chunk, splits = _plan(q.shape, k.shape, q.dtype, _num_sms(index))
    out = torch.empty_like(q)
    lib = _load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = counters = None
    if route.startswith("split_decode"):
        part, counters = _split_scratch(
            index, stream, b * kv * splits * SPLIT_ROWS * (d + 2), b * kv)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr(), DTYPES[q.dtype], b, sq, sk, h,
            kv, d, int(window or 0), float(soft_cap or 0.0),
            ROUTES.index(route), chunk, splits,
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(), stream)
    if index == torch.cuda.current_device():
        err = lib.flash_attention_fwd(*args)
    else:
        with torch.cuda.device(q.device):
            err = lib.flash_attention_fwd(*args)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"({msg})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def reset_launches():
    flash_attention.launches = 0
