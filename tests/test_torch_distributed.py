"""launch/distributed.py, launch/mesh.py and sharding/rules.py on the CPU:
the REPRO_DIST_* contract, free_port, a two-rank gloo smoke (collectives,
the cohort mesh, barrier and kv_allmax through the job's store, from a
second thread too), a failing child stopping its peer within seconds, the
spawner's deadline, and the row and edge-piece arithmetic."""
import os
import socket
import sys
import time

import pytest

from repro_torch.launch import distributed, mesh
from repro_torch.sharding.rules import (edge_pieces, local_row_range,
                                        padded_rows)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": os.path.join(ROOT, "src")}

SMOKE = r"""
import threading
import torch
import torch.distributed as dist
from repro_torch.launch import distributed, mesh
ctx = distributed.maybe_initialize(timeout_s=60)
assert ctx.num_processes == 2 and ctx.backend == "gloo", ctx
assert distributed.process_count() == 2
assert distributed.is_coordinator() == (ctx.process_id == 0)
m = mesh.make_cohort_mesh()
assert mesh.mesh_info(m) == {"axis_names": ("clients",), "shape": (2,),
                             "num_devices": 2}, mesh.mesh_info(m)
x = torch.tensor([float(ctx.process_id + 1)])
dist.all_reduce(x, group=m.get_group())
assert x.item() == 3.0, x
# kv_allmax from another thread, as the staging producer calls it
got = {}
th = threading.Thread(target=lambda: got.update(
    m=distributed.kv_allmax("smoke", 10 * ctx.process_id + 5)))
th.start()
th.join(60)
assert not th.is_alive() and got["m"] == 15, got
distributed.barrier("smoke")
print("SMOKE_OK", ctx.process_id, flush=True)
"""

FAIL = r"""
import sys, time
from repro_torch.launch import distributed
ctx = distributed.maybe_initialize(timeout_s=60)
if ctx.process_id == 1:
    sys.exit(3)
distributed.barrier("never", timeout_s=60)    # waits on the dead peer
"""


def test_env_contract():
    assert distributed.dist_env({}) is None
    ctx = distributed.dist_env({distributed.ENV_COORD: "127.0.0.1:1234",
                                distributed.ENV_NPROCS: "4",
                                distributed.ENV_PID: "3",
                                distributed.ENV_LOCAL_DEVICES: "2",
                                distributed.ENV_BACKEND: "gloo"})
    assert ctx == distributed.DistContext("127.0.0.1:1234", 4, 3, 2, "gloo")
    assert ctx.local_rank == 1
    one = distributed.dist_env({distributed.ENV_COORD: "h:1",
                                distributed.ENV_NPROCS: "2"})
    assert (one.process_id, one.local_devices, one.backend) == (0, 2, None)
    # outside a job: one process, the coordinator, no-op barrier and max
    assert distributed.maybe_initialize() is None
    assert distributed.process_count() == 1 and distributed.is_coordinator()
    distributed.barrier("alone")
    assert distributed.kv_allmax("alone", 7) == 7


def test_free_port_is_bindable():
    port = distributed.free_port()
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", port))


def test_two_rank_smoke():
    res = distributed.spawn_local([sys.executable, "-c", SMOKE], 2,
                                  env=ENV, timeout_s=120)
    assert [r[0] for r in res] == [0, 0]
    assert [r[1].split() for r in res] == [["SMOKE_OK", "0"],
                                           ["SMOKE_OK", "1"]]


def test_a_failing_child_stops_its_peer_at_once():
    tic = time.monotonic()
    with pytest.raises(RuntimeError, match="child 1 exited 3"):
        distributed.spawn_local([sys.executable, "-c", FAIL], 2, env=ENV,
                                timeout_s=120)
    assert time.monotonic() - tic < 30


def test_the_deadline_kills_every_child():
    tic = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out after 1.0 s"):
        distributed.spawn_local(
            [sys.executable, "-c", "import time; time.sleep(60)"], 2,
            timeout_s=1.0)
    assert time.monotonic() - tic < 20


def test_rows_and_edge_pieces():
    assert padded_rows(3, 2) == 4 and padded_rows(10, 4) == 12
    assert [local_row_range(r, 2, 4) for r in range(2)] == [(0, 2), (2, 4)]
    assert local_row_range(0, 1, 5) == (0, 5)
    with pytest.raises(ValueError, match="do not split"):
        local_row_range(0, 2, 5)
    assert edge_pieces(0, 4, 4) == [(0, 4)]
    assert edge_pieces(0, 4, 4, 2) == [(0, 2), (2, 4)]
    # a rank's rows across an edge boundary: one piece each side
    assert edge_pieces(2, 4, 4, 4) == [(2, 3), (3, 4)]
    assert edge_pieces(3, 9, 12, 2) == [(3, 6), (6, 9)]
    with pytest.raises(ValueError, match="must divide"):
        edge_pieces(0, 4, 4, 3)


MESH2D = r"""
import torch
import torch.distributed as dist
from repro_torch.launch import distributed, mesh
ctx = distributed.maybe_initialize(timeout_s=60)
m = mesh.make_cohort_mesh(model=2)
assert mesh.mesh_info(m) == {"axis_names": ("clients", "model"),
                             "shape": (1, 2), "num_devices": 2}, \
    mesh.mesh_info(m)
g = m["model"].get_group()
assert dist.get_world_size(g) == 2 and dist.get_rank(g) == ctx.process_id
assert dist.get_world_size(m["clients"].get_group()) == 1
x = torch.tensor([float(ctx.process_id + 1)])
dist.all_reduce(x, group=g)
assert x.item() == 3.0, x
for bad in (3, 0):
    try:
        mesh.make_cohort_mesh(model=bad)
    except ValueError as e:
        assert "does not divide" in str(e), e
    else:
        raise AssertionError(bad)
print("MESH2D_OK", ctx.process_id, flush=True)
del g, m      # the exit teardown (distributed._leave) frees the groups
"""


def test_the_mesh_accepts_the_model_axis_and_needs_a_job():
    """The model axis no longer raises: make_cohort_mesh(model=2) on two
    ranks is the (1 x 2) ("clients", "model") mesh with its two process
    groups; a model size that does not divide the ranks raises the
    reference's "does not divide", and any mesh needs the job."""
    res = distributed.spawn_local([sys.executable, "-c", MESH2D], 2,
                                  env=ENV, timeout_s=120)
    assert [r[1].split() for r in res] == [["MESH2D_OK", "0"],
                                           ["MESH2D_OK", "1"]]
    with pytest.raises(RuntimeError, match="maybe_initialize"):
        mesh.make_cohort_mesh(model=2)
    with pytest.raises(RuntimeError, match="maybe_initialize"):
        mesh.make_cohort_mesh()
