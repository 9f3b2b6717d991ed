"""The port's hand-written CUDA kernels, each with its wrapper (``ops``),
its plain PyTorch version (``ref``) and its source (``csrc``)."""
from __future__ import annotations

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
