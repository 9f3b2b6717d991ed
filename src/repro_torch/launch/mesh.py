"""The cohort trainer's device mesh and the card's terms for the
roofline; counterpart of repro/launch/mesh.py.

A function, not a module-level object: importing this module queries no
device and starts no process group.

The port runs one process per rank, each on its own device, so the
client axis is the job's ranks: ``make_cohort_mesh`` is a 1-D
``DeviceMesh`` over ``("clients",)``, whose process group carries the
cohort round's collectives (core/round.py). The model axis (a two-axis
``(clients, model)`` mesh whose params shard per leaf) and the
reference's production and debug meshes of the dry-run tooling are not
ported (ROADMAP Queue 1 items 13 and 15).
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


def refuse_model_axis(model: int) -> None:
    """The model axis is not ported: model > 1 raises."""
    if model > 1:
        raise NotImplementedError(
            f"model={model}: the model axis (params sharded per leaf over "
            "a two-axis (clients, model) mesh) is not ported yet (ROADMAP "
            "Queue 1 item 13); the port shards the client axis only")


def make_cohort_mesh(num_devices: int = None, axis: str = "clients",
                     model: int = 1):
    """A 1-D DeviceMesh over every rank of the joined job, named
    ``(axis,)``: rank r holds the r-th contiguous slice of the padded
    cohort (sharding/rules.local_row_range). ``num_devices`` must be the
    job's world size (or None). The mesh's device type is "cuda" under
    NCCL and "cpu" under gloo, whose mesh is a CPU mesh even where its
    ranks compute on a card (gloo moves the card's tensors itself).
    Needs the process group (launch/distributed.maybe_initialize);
    ``model > 1`` raises."""
    refuse_model_axis(model)
    if not dist.is_initialized():
        raise RuntimeError("make_cohort_mesh needs the job's process group "
                           "(launch/distributed.maybe_initialize)")
    n = dist.get_world_size()
    if num_devices not in (None, n):
        raise ValueError(f"num_devices={num_devices}: the client axis spans "
                         f"the job's {n} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda" if dist.get_backend() == "nccl"
                            else "cpu", (n,), mesh_dim_names=(axis,))


def mesh_info(mesh) -> dict:
    return {"axis_names": tuple(mesh.mesh_dim_names),
            "shape": tuple(mesh.mesh.shape),
            "num_devices": int(mesh.mesh.numel())}
