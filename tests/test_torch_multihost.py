"""The port's client axis across processes on the CPU: one two-process
gloo job (tests/_torch_multihost_worker.py, spawned by
launch/distributed.spawn_local) runs every cell of
_torch_matrix_task.CELLS with shard_clients, and this process holds each
against the port's serial run and the reference's serial run on the same
task (params, server state, losses and diagnostics within rtol 1e-5 and
atol 1e-6, f32), prefetch on against off bitwise, the two ranks against
each other bitwise, the two-process checkpoint resumed on one process by
both packages, a one-process checkpoint resumed on two ranks, and the
training CLI on two ranks against the reference CLI."""
import functools
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

import _matrix_task as ref_task
import _torch_matrix_task as task
from repro.core import api as ref_api
from repro.core.faults import FaultPlan as RefFaultPlan
from repro_torch import bridge
from repro_torch.launch import distributed
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_multihost_worker.py")
RTOL, ATOL = 1e-5, 1e-6
CUT = 2
EDGE_FIELDS = ("comm_bytes_up", "comm_bytes_edge_up",
               "comm_bytes_server_up", "edge_dropped", "quarantined",
               "clipped")


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The job's dumps: a one-process checkpoint at round 2 for the ranks
    to resume, then both ranks' runs. While the ranks run (one thread
    each), the reference's CLI runs in a process of its own and this
    process runs the serial runs of both packages, which the tests
    compare with."""
    out = str(tmp_path_factory.mktemp("multihost"))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", *task.CLI_ARGS,
         "--out", os.path.join(out, "ref_cli.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        with task.port_trainer("feddpc") as tr:
            for t in range(CUT):
                tr.run_round(t)
            tr.save(os.path.join(out, "ckpt1"))
        failure = []

        def spawn():
            try:
                distributed.spawn_local(
                    [sys.executable, WORKER, "--out", out], 2,
                    timeout_s=240, env={"PYTHONPATH": env["PYTHONPATH"]})
            except RuntimeError as e:
                failure.append(e)
        ranks = threading.Thread(target=spawn)
        ranks.start()
        try:
            for cell in task.CELLS:
                port_serial(cell)
                ref_serial(cell)
        finally:
            ranks.join(300)
        cli_out, _ = cli.communicate(timeout=300)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    assert cli.returncode == 0, cli_out[-3000:]
    assert not ranks.is_alive()
    if failure:
        raise failure[0]
    return out


def _load(out, tag, rank=0):
    arrays = dict(np.load(os.path.join(out, f"{tag}_r{rank}.npz")))
    with open(os.path.join(out, f"{tag}_r{rank}.json")) as fh:
        return arrays, json.load(fh)


@functools.lru_cache(maxsize=None)
def port_serial(cell):
    with task.port_trainer(cell, vectorize=False) as tr:
        tr.run()
    return tr


@functools.lru_cache(maxsize=None)
def ref_serial(cell):
    """The reference's serial trainer of a cell (its task, in JAX)."""
    name, k, cell_kw, plan = task.CELLS[cell]
    cfg = ref_api.ExecConfig(rounds=task.ROUNDS, clients_per_round=k,
                             seed=task.SEED, eval_every=10 ** 9,
                             vectorize=False, **cell_kw)
    with ref_api.FederatedTrainer(
            ref_task.loss_fn, ref_task.make_params(), task.NUM_CLIENTS,
            ref_task.batch_fn, cfg,
            algo=ref_api.AlgoConfig(name=name, eta_l=task.ETA_L,
                                    eta_g=task.ETA_G),
            fault_plan=(None if plan is None
                        else RefFaultPlan.seeded(0, **plan))) as tr:
        tr.run()
    return tr


def _ref_flat(tr, layout):
    params = bridge.flat_from_reference(
        jax.tree.map(np.asarray, tr.params), layout).numpy()
    state = {k: v.numpy() for k, v in bridge.server_state_from_reference(
        jax.tree.map(np.asarray, tr.server_state), layout).items()}
    return params, state


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _check_run(arrays, meta, want_params, want_state, want_hist, what):
    _close(arrays["params"], want_params, f"{what}: params")
    assert {k[6:] for k in arrays if k.startswith("state_")} == \
        set(want_state), what
    for k, v in want_state.items():
        _close(arrays[f"state_{k}"], v, f"{what}: state {k}")
    hist = meta["history"]
    assert len(hist) == len(want_hist), what
    for got, want in zip(hist, want_hist):
        _close(got["train_loss"], want.train_loss, f"{what}: loss")
        assert set(got["diagnostics"]) == set(want.diagnostics), what
        for key, v in want.diagnostics.items():
            _close(got["diagnostics"][key], float(v), f"{what}: {key}")
        for f in EDGE_FIELDS:
            assert got[f] == getattr(want, f), (what, f, got[f])


@pytest.mark.parametrize("cell", list(task.CELLS))
def test_two_ranks_match_the_serial_runs(job, cell):
    arrays, meta = _load(job, f"{cell}_prefetch1")
    serial = port_serial(cell)
    assert meta["schedule"] == [s.tolist() for s in
                                serial.state().schedule]
    _check_run(arrays, meta, serial.flat.numpy(),
               {k: v.numpy() for k, v in serial.server_state.items()},
               serial.history, f"{cell} vs the port's serial run")
    ref = ref_serial(cell)
    params, state = _ref_flat(ref, serial.layout)
    _check_run(arrays, meta, params, state, ref.history,
               f"{cell} vs the reference's serial run")


@pytest.mark.parametrize("cell", list(task.CELLS))
def test_prefetch_on_and_off_and_the_ranks_agree_bitwise(job, cell):
    on, meta = _load(job, f"{cell}_prefetch1")
    for tag, rank in ((f"{cell}_prefetch0", 0), (f"{cell}_prefetch1", 1),
                      (f"{cell}_prefetch0", 1)):
        other, other_meta = _load(job, tag, rank)
        assert set(other) == set(on)
        for k in on:
            np.testing.assert_array_equal(other[k], on[k],
                                          err_msg=(tag, rank, k))
        assert [r["train_loss"] for r in other_meta["history"]] == \
            [r["train_loss"] for r in meta["history"]]


@pytest.mark.parametrize("cell", list(task.CELLS))
def test_each_rank_holds_its_rows_and_two_collectives(job, cell):
    """Rank r holds rows [r, r+1) x padded K / 2; a round makes one
    all-gather and one all-reduce (FedVARP gathers the rows instead of
    the all-reduce; error feedback adds one)."""
    k = task.CELLS[cell][1]
    per = -(-k // 2)
    want = ["all_gather", "all_reduce"]
    if cell == "fedvarp":
        want = ["all_gather", "all_gather"]
    if cell == "feddpc_int8_ef":
        want = ["all_gather", "all_reduce", "all_reduce"]
    for rank in (0, 1):
        _, meta = _load(job, f"{cell}_prefetch1", rank)
        assert meta["rows"] == [rank * per, (rank + 1) * per]
        assert meta["collectives"] == [want] * task.ROUNDS


def test_edge_drop_masks_the_dropped_edge(job):
    """Round 1 loses edge 1's summary (rank 1's rows): edge_dropped 1, one
    summary on the server uplink, every client still shipped to its
    edge, and round 1's loss is no longer the whole cohort's (the serial
    runs of both packages hold the rest)."""
    _, meta = _load(job, "feddpc_edge_drop_prefetch1")
    _, plain = _load(job, "feddpc_prefetch1")
    hist = meta["history"]
    assert [r["edge_dropped"] for r in hist] == [0, 1, 0]
    full = hist[0]["comm_bytes_server_up"]
    assert hist[1]["comm_bytes_server_up"] * 2 == full
    assert hist[1]["comm_bytes_edge_up"] == hist[0]["comm_bytes_edge_up"]
    assert hist[0]["train_loss"] == plain["history"][0]["train_loss"]
    assert hist[1]["train_loss"] != plain["history"][1]["train_loss"]


def test_two_process_checkpoint_resumes_on_one_process(job):
    """Rank 0's checkpoint at round 2 resumes in this process, in the
    port and in the reference, and lands on the two-process end."""
    end, end_meta = _load(job, "cut")
    ckpt = os.path.join(job, "ckpt2")
    with open(os.path.join(ckpt, f"step_{CUT:08d}", "aux.json")) as fh:
        assert json.load(fh)["exec_mesh"] == {
            "shard_clients": True, "shard_model": 1, "devices": 2}
    tr = task.port_trainer("feddpc")
    tr.restore(ckpt)
    assert tr.start_round == CUT
    with tr:
        tr.run()
    _close(tr.flat.numpy(), end["params"], "port resume")
    _close(tr.history[-1].train_loss,
           end_meta["history"][-1]["train_loss"], "port resume loss")
    name, k, cell_kw, _ = task.CELLS["feddpc"]
    ref = ref_api.FederatedTrainer.resume(
        ckpt, ref_task.loss_fn, ref_task.make_params(), task.NUM_CLIENTS,
        ref_task.batch_fn,
        ref_api.ExecConfig(rounds=task.ROUNDS, clients_per_round=k,
                           seed=task.SEED, eval_every=10 ** 9, **cell_kw),
        algo=ref_api.AlgoConfig(name=name, eta_l=task.ETA_L,
                                eta_g=task.ETA_G))
    assert ref.start_round == CUT
    with ref:
        ref.run()
    _close(_ref_flat(ref, tr.layout)[0], end["params"], "reference resume")
    assert [r.edge_dropped for r in ref.history] == [0] * task.ROUNDS
    _close(ref.history[-1].train_loss,
           end_meta["history"][-1]["train_loss"], "reference resume loss")


def test_one_process_checkpoint_resumes_on_two_ranks(job):
    arrays, meta = _load(job, "resumed2")
    serial = port_serial("feddpc")
    _close(arrays["params"], serial.flat.numpy(), "1 -> 2 resume")
    assert [r["round"] for r in meta["history"]] == list(range(task.ROUNDS))
    assert meta["collectives"] == [["all_gather", "all_reduce"]] * (
        task.ROUNDS - CUT)


def test_cli_on_two_ranks_matches_the_reference_cli(job):
    """The port's CLI on the two ranks (--shard-clients --edges 2)
    against the reference's CLI (--edges 2, one process)."""
    with open(os.path.join(job, "ref_cli.json")) as fh:
        want = json.load(fh)
    with open(os.path.join(job, "cli.json")) as fh:
        got = json.load(fh)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g["train_loss"], w["train_loss"], "CLI loss")
        for f in ("comm_bytes_up", "comm_bytes_edge_up",
                  "comm_bytes_server_up", "edge_dropped"):
            assert g[f] == w[f], f
