"""The cohort trainer's device mesh and the card's terms for the
roofline; counterpart of repro/launch/mesh.py.

A function, not a module-level object: importing this module queries no
device and starts no process group.

The port runs one process per rank, each on its own device, so both
axes of the reference's cohort mesh are the job's ranks:
``make_cohort_mesh()`` is a 1-D ``DeviceMesh`` over ``("clients",)``,
and ``make_cohort_mesh(model=M)`` a 2-D ``(world // M, M)`` mesh over
``("clients", "model")`` with rank = c·M + m, row-major as the reference
lays out its devices. ``mesh["clients"]`` and ``mesh["model"]`` give the
process groups that carry the cohort round's collectives
(core/round.py). The reference's production and debug meshes of the
dry-run tooling are not ported (ROADMAP Queue 1, item 15).
"""
from __future__ import annotations

import torch.distributed as dist

# One NVIDIA H100 80GB HBM3 (SXM) at its full 700 W power limit, from
# NVIDIA's data sheet (dense rates): what the bounds are taken against. A
# card set below 700 W runs slower under load; chip_smoke.py prints the
# limit of the card it ran on.
CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, outside the tensor cores
HBM_BW = 3.35e12                  # B/s
NVLINK_BW = 450e9                 # B/s each way per card (900 GB/s both)
HBM_BYTES = 80e9


def make_cohort_mesh(num_devices: int = None, axis: str = "clients",
                     model: int = 1):
    """A DeviceMesh over every rank of the joined job: 1-D ``(axis,)``
    for ``model == 1``, where rank r holds the r-th contiguous slice of
    the padded cohort (sharding/rules.local_row_range); 2-D
    ``(world // model, model)`` named ``(axis, "model")`` otherwise, rank
    c·model + m at client coordinate c and model coordinate m.
    ``num_devices`` must be the job's world size (or None), and
    ``model`` must divide it. The mesh's device type is "cuda" under
    NCCL and "cpu" under gloo, whose mesh is a CPU mesh even where its
    ranks compute on a card (gloo moves the card's tensors itself).
    Needs the process group (launch/distributed.maybe_initialize)."""
    if not dist.is_initialized():
        raise RuntimeError("make_cohort_mesh needs the job's process group "
                           "(launch/distributed.maybe_initialize)")
    n = dist.get_world_size()
    if num_devices not in (None, n):
        raise ValueError(f"num_devices={num_devices}: the mesh spans the "
                         f"job's {n} ranks")
    if model < 1 or n % model:
        raise ValueError(
            f"model={model} does not divide the {n} ranks of the job; a "
            f"({axis}, model) mesh needs clients x model == ranks")
    from torch.distributed.device_mesh import init_device_mesh
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if model == 1:
        return init_device_mesh(device, (n,), mesh_dim_names=(axis,))
    return init_device_mesh(device, (n // model, model),
                            mesh_dim_names=(axis, "model"))


def mesh_info(mesh) -> dict:
    return {"axis_names": tuple(mesh.mesh_dim_names),
            "shape": tuple(mesh.mesh.shape),
            "num_devices": int(mesh.mesh.numel())}
