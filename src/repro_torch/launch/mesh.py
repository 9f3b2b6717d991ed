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
collective). ``make_production_mesh`` is the dry-run's (16, 16) or
(2, 16, 16) mesh over a fake process group of 256 or 512 ranks
(launch/dryrun.py).
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


# multi_pod -> (the mesh over the fake group, its 1-D mesh of the data
# axes)
_production = {}


def make_production_mesh(*, multi_pod: bool = False):
    """The dry-run's production mesh (launch/dryrun.py): the (16, 16)
    ``("data", "model")`` mesh of 256 ranks, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` mesh of 512, as a
    ``DeviceMesh`` over a FAKE process group (torch's "fake" backend:
    its collectives move nothing and return at once) in which this
    process is rank 0, rank = (p·16 + d)·16 + m. The steps run on meta
    tensors over it; each collective is recorded, not carried out.

    Like the reference's dry-run, which fixes its 512 placeholder
    devices at JAX's start, it needs a process of its own: it starts the
    global group, and raises if a real job's group is already up. Called
    again for the other mesh it starts the fake group anew (its world
    size changes). The multi-pod mesh's ``mesh["pod", "data"]`` is
    flattened once: the 32 ranks of the data axes, the group of the
    gradient sums (``production_data_group``)."""
    world = 512 if multi_pod else 256
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "make_production_mesh: a real job's process group is up "
                f"({dist.get_backend()}); the dry-run's fake 256- and "
                "512-rank meshes need a process of their own")
        if multi_pod in _production:
            return _production[multi_pod][0]
        dist.destroy_process_group()
    _production.clear()
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    if multi_pod:
        mesh = init_device_mesh("cpu", (2, 16, 16),
                                mesh_dim_names=("pod", "data", "model"))
        data = mesh["pod", "data"]._flatten("pod_data")
    else:
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        data = mesh["data"]
    _production[multi_pod] = (mesh, data)
    return mesh


def production_data_group(mesh):
    """The process group of ``make_production_mesh``'s data axes: "data"
    (16 ranks), or pod x data flattened (32 ranks)."""
    return next(d for m, d in _production.values() if m is mesh).get_group()


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
