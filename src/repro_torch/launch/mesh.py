"""The trainer's and the train step's device meshes and the card's terms
for the roofline; counterpart of repro/launch/mesh.py.

Functions, not module-level objects: importing this module queries no
device and starts no process group.

The port runs one process per rank, each on its own device, so every
axis of the reference's meshes is the job's ranks:
``make_cohort_mesh()`` is a 1-D ``DeviceMesh`` over ``("clients",)``,
and ``make_cohort_mesh(model=M)`` a 2-D ``(world // M, M)`` mesh over
``("clients", "model")`` with rank = c·M + m, row-major as the reference
lays out its devices. ``mesh["clients"]`` and ``mesh["model"]`` give the
process groups that carry the cohort round's collectives
(core/round.py). ``make_debug_mesh(data, model)`` is the (data, model)
mesh of the expert-parallel train step (models/moe_ep.py,
launch/steps.make_train_step(moe_impl="ep")), rank = d·M + m; a 1 x 1
one without a job is this process alone (``LocalMesh``: no group, no
collective). The reference's production mesh of the dry-run tooling (512
placeholder devices) is not ported (ROADMAP Queue 1, item 15).
"""
from __future__ import annotations

import torch
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


class LocalMesh:
    """A (data, model) mesh of this one process with no process group: a
    1 x 1 ``make_debug_mesh`` outside a job. Every axis has one rank, so
    nothing over it needs a group (``axis_group`` gives None)."""
    mesh_dim_names = ("data", "model")

    def __init__(self):
        self.mesh = torch.zeros((1, 1), dtype=torch.int64)

    def get_coordinate(self):
        return [0, 0]


def make_debug_mesh(data: int = 1, model: int = 1):
    """The (data, model) mesh of the expert-parallel step: a 2-D
    ``DeviceMesh`` over every rank of the joined job, named ``("data",
    "model")``, rank d·model + m at data coordinate d and model
    coordinate m (as ``make_cohort_mesh``); ``data * model`` must be the
    job's world size. A 1 x 1 mesh outside a job is a ``LocalMesh``."""
    if data < 1 or model < 1:
        raise ValueError(f"a ({data}, {model}) mesh")
    if not dist.is_initialized():
        if data * model == 1:
            return LocalMesh()
        raise RuntimeError("make_debug_mesh needs the job's process group "
                           "(launch/distributed.maybe_initialize) for "
                           f"a ({data}, {model}) mesh")
    n = dist.get_world_size()
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs data x model == "
                         f"the job's {n} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's dry-run mesh over 512 placeholder devices has no
    port yet."""
    raise NotImplementedError(
        "make_production_mesh: the dry-run's mesh of 512 placeholder "
        "devices (a (16, 16) or (2, 16, 16) TPU v5e layout) has no port; "
        "it is ROADMAP Queue 1 item 15")


def axis_group(mesh, axis: str):
    """The process group of ``axis`` on ``mesh`` (this rank's), or None
    where the axis has one rank (a ``LocalMesh``'s)."""
    if mesh_info(mesh)["shape"][mesh.mesh_dim_names.index(axis)] == 1:
        return None
    return mesh[axis].get_group()


def mesh_info(mesh) -> dict:
    return {"axis_names": tuple(mesh.mesh_dim_names),
            "shape": tuple(mesh.mesh.shape),
            "num_devices": int(mesh.mesh.numel())}
