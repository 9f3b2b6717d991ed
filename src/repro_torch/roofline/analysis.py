"""Three-term roofline of one rank's step, counted as it runs on meta
tensors (counterpart of repro/roofline/analysis.py):

  compute    = FLOPs            / PEAK_FLOPS_BF16
  memory     = bytes            / HBM_BW
  collective = collective bytes / NVLINK_BW

against one NVIDIA H100 80GB HBM3 at its 700 W limit (launch/mesh.py's
data-sheet figures; ``NVLINK_BW`` stands where the reference has its
TPU's ICI rate). Every count is this rank's, as the reference's
``cost_analysis`` of an SPMD-partitioned module is per device.

The reference reads XLA's ``cost_analysis`` of the compiled step and
parses the collectives out of its optimized HLO. The port has no
compiler to ask: ``analyze_compiled`` runs the rank's step eagerly on
meta tensors (launch/dryrun.py) and counts what it does:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s, the
    matmul-class ops (mm, bmm, addmm, baddbmm, convolution, attention),
    forward and backward (remat's recompute counted again, as XLA counts
    it), plus each hand-written kernel's own count from its shapes
    (kernels.meta_cost: the FLOPs behind its bound). Elementwise and
    reduction ops add none (XLA's count includes them; at these shapes
    they are a small share).
  * Bytes: every aten op that is not a view — its inputs read once and
    its outputs written once (an in-place op reads and writes its
    destination; ``copy_``, ``fill_`` and ``zero_`` only write it) —
    plus each kernel's bytes (inputs once, outputs once). These are
    unfused eager ops, so the count reads higher than XLA's fused
    ``bytes accessed``: each op's intermediate goes to memory and back.
  * Collective bytes: every ``torch.distributed`` collective the step
    calls (the c10d ops the dispatcher sees), sized by its result as the
    reference sizes an HLO collective by its result shape: an all-reduce
    its tensor, an all-gather the gathered tensor, a reduce-scatter the
    rank's piece, an all-to-all its output (``collective_bytes`` sums the
    record by kind).
  * Memory per device: a lower bound — the rank's arguments (params or
    shard, states, inputs) plus the outputs it allocates, each storage
    once (an output written in place into an argument adds nothing).
    Temporaries are not counted: a meta tensor frees nothing that can be
    watched.

``model_flops`` is the reference's 6·N·D (2·N·D to serve), copied.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels
from repro_torch.launch.mesh import (CARD, HBM_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16, POWER_LIMIT_W)

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

# c10d op -> its kind; the result is the op's first argument (the output
# list or tensor; an all-reduce's tensors are written in place)
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_NOT_COLLECTIVES = ("barrier", "monitored_barrier")
# ops that move no bytes: allocations without a write, an alias the
# schema does not mark as a view, and storage bookkeeping
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "_unsafe_view", "set_", "resize_",
             "_local_scalar_dense"}
_WRITE_ONLY = {"copy_", "fill_", "zero_"}


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _size(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Bytes(TorchDispatchMode):
    """Counts the bytes of every non-view aten op and records every c10d
    collective (module docstring)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collectives: List[Tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "c10d":
            if name in _C10D:
                self.collectives.append(
                    (_C10D[name], sum(_size(t) for t in _tensors(args[0]))))
            elif name not in _NOT_COLLECTIVES:
                raise ValueError(f"the roofline has no kind for c10d.{name}")
            return out
        if func.is_view or name in _NO_BYTES:
            return out
        seen, moved = set(), 0
        inputs = _tensors((args, kwargs))
        if name in _WRITE_ONLY:
            inputs = inputs[1:]
        for t in inputs:
            if id(t) not in seen:
                seen.add(id(t))
                moved += _size(t)
        self.bytes += moved + sum(_size(t) for t in _tensors(out))
        return out


@dataclass
class Count:
    """What one counted run did: FLOPs and bytes (the eager ops' and the
    kernels'), the collectives [(kind, bytes)] in call order and the
    kernels' meta launches [(name, flops, bytes)]."""
    flops: int = 0
    bytes: int = 0
    collectives: List[Tuple[str, int]] = field(default_factory=list)
    kernels: List[Tuple[str, int, int]] = field(default_factory=list)


class OpCounter:
    """``with OpCounter() as c: ...`` counts what the block runs
    (module docstring) into ``c.count`` when it ends. Counters nest: an
    inner one sees only its block (an outer one also sees the block's
    ops, but not the inner one's kernel records)."""

    def __enter__(self):
        self._flops = FlopCounterMode(display=False)
        self._bytes = _Bytes()
        self._kernels = kernels.meta_costs()
        self._records = self._kernels.__enter__()
        self._flops.__enter__()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        self._kernels.__exit__(*exc)
        recs = list(self._records)
        self.count = Count(
            flops=int(self._flops.get_total_flops())
            + sum(f for _, f, _ in recs),
            bytes=self._bytes.bytes + sum(b for _, _, b in recs),
            collectives=list(self._bytes.collectives), kernels=recs)
        return False


def collective_bytes(calls) -> Dict[str, int]:
    """Result bytes per collective kind, summed over ``calls``, the
    port's record of the collectives a step called ([(kind, bytes)];
    ``Count.collectives``)."""
    out = {k: 0 for k in COLLECTIVE_OPS}
    for kind, nbytes in calls:
        out[kind] += int(nbytes)
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device bytes read and written
    coll_bytes: Dict[str, int] = field(default_factory=dict)
    model_flops_total: float = 0.0   # 6*N*D useful flops (whole step)
    memory_per_device: float = 0.0   # arguments + outputs (a lower bound)

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll_bytes.values()))

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_total / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / (chips * FLOPs) — how much counted compute is
        'useful' model math (catches remat and redundant work: heads
        every rank computes whole, sharding/layout.tp_classes)."""
        total = self.flops * self.chips
        return self.model_flops_total / total if total else 0.0

    def as_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes": dict(self.coll_bytes),
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops_total,
            "useful_fraction": self.useful_fraction,
            "memory_per_device_bytes": self.memory_per_device,
        }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = tokens in the
    step; x3 for training (fwd+bwd). Decode processes B*1 tokens.
    Encoder-decoder (whisper): decoder length is capped at max_seq_len (the
    32k/500k shapes are cache-capacity stress shapes, not real decode
    lengths), plus the encoder runs once over encoder_seq_len frames."""
    counts = cfg.param_counts()
    n = counts["active"]
    seq = shape.seq_len
    if cfg.is_encoder_decoder:
        seq = min(seq, cfg.max_seq_len)
    if shape.kind == "train":
        tokens = shape.global_batch * seq
        mult = 6.0                      # 2 fwd + 4 bwd per param per token
    elif shape.kind == "prefill":
        tokens = shape.global_batch * seq
        mult = 2.0
    else:
        tokens = shape.global_batch * 1
        mult = 2.0
    return mult * n * tokens


def _storages(tensors) -> Dict[int, int]:
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tensors}


def analyze_compiled(step, args, *, arch: str, shape_name: str,
                     mesh_name: str, chips: int,
                     model_flops_total: float) -> Roofline:
    """Run ``step(*args)`` (one rank's step on meta tensors) under an
    ``OpCounter`` and return its roofline (module docstring). The
    count is also kept as ``.count`` on the result."""
    with OpCounter() as c:
        out = step(*args)
    held = _storages(_tensors(args))
    new = {k: v for k, v in _storages(_tensors(out)).items()
           if k not in held}
    rl = Roofline(arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
                  flops=float(c.count.flops), hbm_bytes=float(c.count.bytes),
                  coll_bytes=collective_bytes(c.count.collectives),
                  model_flops_total=model_flops_total,
                  memory_per_device=float(sum(held.values())
                                          + sum(new.values())))
    rl.count = c.count
    return rl


def _fmt_secs(s: float) -> str:
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.1f}us"


def roofline_report(rl: Roofline) -> str:
    lines = [
        f"### {rl.arch} x {rl.shape} on {rl.mesh} ({rl.chips} chips; "
        f"terms against one {CARD} at {POWER_LIMIT_W} W)",
        f"- compute    term: {_fmt_secs(rl.t_compute)}  "
        f"({rl.flops:.3e} FLOP/device)",
        f"- memory     term: {_fmt_secs(rl.t_memory)}  "
        f"({rl.hbm_bytes:.3e} B/device)",
        f"- collective term: {_fmt_secs(rl.t_collective)}  "
        f"({rl.coll_total:.3e} B; " + ", ".join(
            f"{k}={v:.2e}" for k, v in rl.coll_bytes.items() if v) + ")",
        f"- dominant: **{rl.dominant}**",
        f"- MODEL_FLOPS={rl.model_flops_total:.3e}, "
        f"useful fraction={rl.useful_fraction:.3f}",
        f"- memory/device: {rl.memory_per_device / 1e9:.2f} GB",
    ]
    return "\n".join(lines)
