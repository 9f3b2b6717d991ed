"""The port's hand-written CUDA kernels, each with its wrapper (``ops``),
its plain PyTorch version (``ref``) and its source (``csrc``).

On meta tensors a wrapper launches nothing: it returns meta outputs of
the kernel's shapes and dtypes and records what one launch would cost
(``meta_cost``: its FLOPs and the bytes of its inputs read once and its
outputs written once, the formula behind the kernel's bound). A
``meta_costs()`` block collects those records; the dry-run's counter
(roofline/analysis.py) adds them to what it counts of the eager ops, as
XLA costs a custom call from its shapes.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
from torch._C._functorch import is_functorch_wrapped_tensor


def refuse_training(name: str, route: str, *tensors) -> None:
    """Raise ValueError when any of ``tensors`` requires grad or is
    wrapped by a ``torch.func`` transform (grad, vmap, jvp): the forward
    kernels have no backward — neither have the reference's Pallas
    kernels — so such a call would hand back a result that autograd
    cannot see through. ``route`` names the path training takes."""
    for t in tensors:
        if t is None:
            continue
        if (t.requires_grad and torch.is_grad_enabled()) \
                or is_functorch_wrapped_tensor(t):
            raise ValueError(
                f"{name}: an input requires grad or is wrapped by a "
                "torch.func transform, and the kernel has no backward; "
                f"training takes {route}")


_sink: Optional[List[Tuple[str, int, int]]] = None


def meta_cost(name: str, flops: int, nbytes: int) -> None:
    """Record one meta launch of kernel ``name`` (dropped outside a
    ``meta_costs()`` block)."""
    if _sink is not None:
        _sink.append((name, int(flops), int(nbytes)))


@contextlib.contextmanager
def meta_costs():
    """Collect ``meta_cost`` records: yields the list they go into."""
    global _sink
    outer, _sink = _sink, []
    try:
        yield _sink
    finally:
        _sink = outer


def nbytes(*tensors) -> int:
    """The bytes of ``tensors`` (None skipped), each read or written
    once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
