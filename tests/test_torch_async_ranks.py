"""The port's buffered-async regime across ranks on the CPU.

One four-process gloo job (tests/_torch_async_ranks_worker.py, spawned by
launch/distributed.spawn_local) runs every cell of
_torch_matrix_task.ASYNC_CELLS — async_buffer, codec_int8_async and
server_fedadam_async on a (4 x 1) and a (2 x 2) (clients, model) mesh,
FedDPC with stragglers on both, and on (2 x 2) FedVARP under a Markov
sampler, int8_sr with error feedback, and guarded int8 with a fault plan
and a round deadline, the last five under ExponentialRuntime, B = 2 < K
= 4 and three waves in flight — and this process holds each against the
port's and the reference's one-process async runs: params, server state,
the optimizer's moments, error feedback, losses and diagnostics within
rtol 1e-5 and atol 1e-6 (the codec cells against the reference's within
its CODEC_TOL), every fold's arrivals (client, wave, version) and
staleness exactly the reference engine's, every rank against the others
bitwise on what is replicated, prefetch on against off bitwise, the
positions each rank held and the kernels it launched against the
arrivals its client slice trained, the async anchor against the ranks'
synchronous round, a (2 x 2) mid-buffer checkpoint resumed in one
process by both packages, a one-process mid-buffer checkpoint resumed on
(4 x 1), and the training CLI with --shard-clients --async-buffer
--model-shards 2 against the reference CLI."""
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
from repro.core import async_engine as ref_engine
from repro.core.faults import FaultPlan as RefFaultPlan
from repro.core.runtime import ExponentialRuntime as RefExponential
from repro.core.samplers import MarkovSampler as RefMarkov
from repro.core.samplers import UniformSampler as RefUniform
from repro_torch import bridge
from repro_torch.core import async_engine
from repro_torch.launch import distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_async_ranks_worker.py")
RTOL, ATOL = 1e-5, 1e-6
# the reference's codec bounds (tests/_regime_matrix_check.py CODEC_TOL;
# importing that module would force 8 host devices on this process)
CODEC_TOL = {"int8": dict(rtol=1e-1, atol=2e-2),
             "int8_sr": dict(rtol=2e-1, atol=5e-2)}
CELLS = list(task.ASYNC_CELLS)
NOPREFETCH = task.ASYNC_NOPREFETCH
CUTS = task.ASYNC_CUTS
RESUME_CELL = "feddpc:stragglers:1"


# ---------------- the four-rank job ----------------

@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The job's dumps: a one-process mid-buffer checkpoint for the ranks
    to resume, then the four ranks' runs. While the ranks run, the
    reference's CLI runs in a process of its own and this process runs
    the one-process async runs of both packages."""
    out = str(tmp_path_factory.mktemp("async_ranks"))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", *task.ASYNC_CLI_ARGS,
         "--out", os.path.join(out, "ref_cli.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        with task.async_trainer(RESUME_CELL, sharded=False) as tr:
            for t in range(task.ASYNC_CUT):
                tr.run_round(t)
            assert tr._engine.inflight()
            tr.save(os.path.join(out, "ckpt1"))
        failure = []

        def spawn():
            try:
                distributed.spawn_local(
                    [sys.executable, WORKER, "--out", out], 4,
                    timeout_s=300, env={"PYTHONPATH": env["PYTHONPATH"]})
            except RuntimeError as e:
                failure.append(e)
        ranks = threading.Thread(target=spawn)
        ranks.start()
        try:
            for cell in CELLS:
                port_single(cell)
                ref_single(cell)
        finally:
            ranks.join(360)
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
def port_single(cell):
    """The port's one-process async run of a cell and its folds."""
    with task.async_trainer(cell, sharded=False) as tr:
        folds = task.record_arrivals(tr, async_engine)
        tr.run()
    return tr, folds


def _ref_trainer(cell, **exec_kw):
    name, kw, rt, sampler, plan = task.async_cell_kw(cell, sharded=False)
    return ref_api.FederatedTrainer(
        ref_task.loss_fn, ref_task.make_params(), task.NUM_CLIENTS,
        ref_task.batch_fn,
        ref_api.ExecConfig(rounds=task.ASYNC_ROUNDS,
                           clients_per_round=task.K, seed=task.SEED,
                           eval_every=10 ** 9, prefetch=False, **kw,
                           **exec_kw),
        algo=ref_api.AlgoConfig(name=name, eta_l=task.ETA_L,
                                eta_g=task.ETA_G),
        sampler=(RefMarkov(task.NUM_CLIENTS, task.K) if sampler == "markov"
                 else RefUniform(task.NUM_CLIENTS, task.K)),
        runtime=RefExponential(mean=1.0) if rt else None,
        fault_plan=(None if plan is None
                    else RefFaultPlan.seeded(0, **plan)))


@functools.lru_cache(maxsize=None)
def ref_single(cell):
    """The reference's one-process async run of a cell (blocking
    staging) and its folds."""
    with _ref_trainer(cell) as tr:
        folds = task.record_arrivals(tr, ref_engine)
        tr.run()
    return tr, folds


def _ref_flat(tr, layout):
    params = bridge.flat_from_reference(
        jax.tree.map(np.asarray, tr.params), layout).numpy()
    state = {k: v.numpy() for k, v in bridge.server_state_from_reference(
        jax.tree.map(np.asarray, tr.server_state), layout).items()}
    return params, state


def _codec(cell):
    return task.async_cell_kw(cell)[1].get("codec")


def _close(got, want, what, tol=None):
    np.testing.assert_allclose(got, want, err_msg=what,
                               **(tol or {"rtol": RTOL, "atol": ATOL}))


RECORD_EQUAL = ("comm_bytes_up", "quarantined", "clipped", "staleness_mean",
                "staleness_max", "deadline_fired", "deadline_dropped")


def _check_run(arrays, meta, want_params, want_state, want_hist, what,
               tol=None):
    _close(arrays["params"], want_params, f"{what}: params", tol)
    assert {k[6:] for k in arrays if k.startswith("state_")} == \
        set(want_state), what
    for k, v in want_state.items():
        _close(arrays[f"state_{k}"], v, f"{what}: state {k}", tol)
    hist = meta["history"]
    assert len(hist) == len(want_hist) == task.ASYNC_ROUNDS, what
    for got, want in zip(hist, want_hist):
        _close(got["train_loss"], want.train_loss, f"{what}: loss", tol)
        assert set(got["diagnostics"]) == set(want.diagnostics), what
        for key, v in want.diagnostics.items():
            _close(got["diagnostics"][key], float(v), f"{what}: {key}", tol)
        for f in RECORD_EQUAL:
            assert got[f] == getattr(want, f), (what, f, got[f])


@pytest.mark.parametrize("cell", CELLS)
def test_async_cells_match_the_one_process_runs(job, cell):
    """Against the port's one-process run at 1e-5 (the optimizer's
    moments and error feedback too), against the reference's at 1e-5 or
    its CODEC_TOL."""
    arrays, meta = _load(job, cell)
    single, _ = port_single(cell)
    assert meta["schedule"] == [s.tolist() for s in
                                single.state().schedule]
    _check_run(arrays, meta, single.flat.numpy(),
               {k: v.numpy() for k, v in single.server_state.items()},
               single.history, f"{cell} vs the port's one-process run")
    for k, v in (single._opt_state or {}).items():
        _close(arrays[f"opt_{k}"], v.numpy(), f"{cell}: moment {k}")
    if single._ef is not None:
        _close(arrays["ef"], single._ef.numpy(), f"{cell}: ef")
    ref, _ = ref_single(cell)
    params, state = _ref_flat(ref, single.layout)
    codec = _codec(cell)
    _check_run(arrays, meta, params, state, ref.history,
               f"{cell} vs the reference's one-process run",
               CODEC_TOL[codec] if codec else None)


@pytest.mark.parametrize("cell", CELLS)
def test_each_fold_has_the_reference_engines_arrivals(job, cell):
    """Every fold's arrivals (client, wave, version), in arrival order,
    and its staleness, exactly the reference's and the port's one
    process's, on every rank."""
    _, ref_folds = ref_single(cell)
    _, port_folds = port_single(cell)
    assert port_folds == ref_folds
    ref, _ = ref_single(cell)
    for rank in range(4):
        _, meta = _load(job, cell, rank)
        assert meta["folds"] == ref_folds, rank
        for fold, rec in zip(meta["folds"], meta["history"]):
            stale = [fold["version"] - v for _, _, v in fold["arrivals"]]
            assert rec["staleness_max"] == max(stale)
            assert rec["staleness_mean"] == float(np.mean(stale))
    assert [r["staleness_max"] for r in meta["history"]] == \
        [r.staleness_max for r in ref.history]
    if task.ASYNC_CELLS[cell][3] is not None:
        assert max(r.staleness_max for r in ref.history) > 0


def _replicated(meta):
    """A run's history without its host-clock fields (each rank's
    own)."""
    return [{k: v for k, v in r.items() if "seconds" not in k}
            for r in meta["history"]]


@pytest.mark.parametrize("cell", CELLS)
def test_ranks_agree_bitwise_and_hold_their_shards(job, cell):
    """Every rank gathers the same params, state, moments and error
    feedback and records the same history, bit for bit; each holds at
    rest its shard of the params (the ranks of one model coordinate the
    same), and the in-flight rows its client slice holds."""
    m_size = task.ASYNC_CELLS[cell][2]
    arrays0, meta0 = _load(job, cell)
    for rank in range(4):
        arrays, meta = _load(job, cell, rank)
        info = meta["shard"]
        # the (4 x 1) mesh is the 1-D client axis
        assert info["mesh"] == ([4] if m_size == 1 else [2, m_size])
        assert info["coords"] == [rank // m_size, rank % m_size]
        for k in arrays0:
            if not k.startswith("shard_"):
                np.testing.assert_array_equal(arrays[k], arrays0[k],
                                              err_msg=(cell, rank, k))
        assert _replicated(meta) == _replicated(meta0), (cell, rank)
        assert arrays["shard_params"].shape == (info["N_m"],)
        if rank >= m_size:
            other, _ = _load(job, cell, rank - m_size)
            np.testing.assert_array_equal(arrays["shard_params"],
                                          other["shard_params"])
        # the collectives every rank issued, in the same order
        assert meta["collectives"] == meta0["collectives"], rank
    if task.ASYNC_CELLS[cell][3] is not None:
        # stragglers stay in flight past the last fold: some rank holds
        # rows of them
        assert sum(_load(job, cell, r)[1]["shard"]["bytes"]["inflight"]
                   for r in range(4)) > 0


@pytest.mark.parametrize("cell", NOPREFETCH)
def test_prefetch_on_and_off_agree_bitwise(job, cell):
    for rank in range(4):
        on, meta = _load(job, cell, rank)
        off, off_meta = _load(job, cell + ":noprefetch", rank)
        assert set(on) == set(off)
        for k in on:
            np.testing.assert_array_equal(off[k], on[k], err_msg=(rank, k))
        assert _replicated(off_meta) == _replicated(meta)
        assert off_meta["folds"] == meta["folds"]


def _held_positions(meta, slice_index, slices):
    """The buffer positions of each fold whose arrival the client slice
    trained: its rows of the wave's cohort."""
    per = task.K // slices
    out = []
    for fold in meta["folds"]:
        out.append([i for i, (c, w, _) in enumerate(fold["arrivals"])
                    if meta["schedule"][w].index(c) // per == slice_index])
    return out


def _expected_calls(cell, held, waves):
    """Per fold with held arrivals: one reduction pass (the guard's under
    the guard) and one buffer fold (the dequant fold with a codec and
    nothing rewriting the decoded rows) for FedDPC; int8_sr's encode once
    a wave on every rank; the FedAvg family none."""
    name, kw, _, _, plan = task.async_cell_kw(cell)
    calls = {}
    if kw.get("codec") == "int8_sr":
        calls["int8_sr_quantize"] = waves
    if name != "feddpc":
        return calls
    folds = sum(1 for h in held if h)
    if folds:
        calls["feddpc_guard_dots" if kw.get("guard")
              else "feddpc_dots"] = folds
        payload = kw.get("codec") and not kw.get("guard") and plan is None
        calls["feddpc_dequant_buffer_fold" if payload
              else "feddpc_buffer_fold"] = folds
    return calls


@pytest.mark.parametrize("cell", CELLS)
def test_each_rank_launches_the_kernels_its_held_arrivals_imply(job, cell):
    m_size = task.ASYNC_CELLS[cell][2]
    slices = 4 // m_size
    for rank in range(4):
        _, meta = _load(job, cell, rank)
        held = _held_positions(meta, rank // m_size, slices)
        assert meta["held"] == held, rank
        assert meta["calls"] == _expected_calls(
            cell, held, len(meta["schedule"])), (rank, meta["calls"])


@pytest.mark.parametrize("m_size", [1, 2])
def test_some_fold_leaves_a_client_slice_without_arrivals(job, m_size):
    """Under stragglers a fold's arrivals can all come from other client
    slices: such a rank launches nothing and still joins the sums (the
    runs above end where one process's do). And the guarded cell's
    deadline folds partial buffers."""
    cells = [c for c, v in task.ASYNC_CELLS.items()
             if v[2] == m_size and v[3] is not None]
    assert any(not h for c in cells for r in range(4)
               for h in _load(job, c, r)[1]["held"])
    _, meta = _load(job, "feddpc:guard_int8:2")
    assert any(r["deadline_fired"] for r in meta["history"])
    assert sum(r["quarantined"] for r in meta["history"]) > 0


def test_anchor_on_ranks_is_the_ranks_sync_round(job):
    """DeterministicRuntime, concurrency 1 and B = K on (4 x 1): the
    ranks' async run is their synchronous round within 1e-5, staleness
    0."""
    a, meta = _load(job, "feddpc:async_buffer:1")
    s, sync_meta = _load(job, "sync:1")
    _close(a["params"], s["params"], "anchor params")
    for k in (k for k in s if k.startswith("state_")):
        _close(a[k], s[k], f"anchor {k}")
    for got, want in zip(meta["history"], sync_meta["history"]):
        _close(got["train_loss"], want["train_loss"], "anchor loss")
        assert got["staleness_max"] == 0.0
        assert got["comm_bytes_up"] == want["comm_bytes_up"]


def _port_resume(ckpt, cell):
    tr = task.async_trainer(cell, sharded=False)
    tr.restore(ckpt)
    assert tr.start_round == task.ASYNC_CUT
    with tr:
        tr.run()
    return tr


def _check_cut(job, tag, cell):
    """The cut run is the uninterrupted one (save changes nothing), and
    its checkpoint, written by rank 0 with entries in flight, names the
    mesh."""
    cut, cut_meta = _load(job, tag)
    whole, whole_meta = _load(job, cell)
    for k in whole:
        np.testing.assert_array_equal(cut[k], whole[k], err_msg=k)
    assert _replicated(cut_meta) == _replicated(whole_meta)
    ckpt = os.path.join(job, f"ckpt_{tag}")
    step = os.path.join(ckpt, f"step_{task.ASYNC_CUT:08d}")
    with open(os.path.join(step, "aux.json")) as fh:
        assert json.load(fh)["exec_mesh"] == {
            "shard_clients": True, "shard_model": 2, "devices": 4}
    aux = np.load(os.path.join(step, "aux.npz"))
    assert int(aux["async_n_inflight"]) > 0
    return cut, cut_meta, ckpt


def test_2x2_mid_buffer_checkpoint_resumes_on_one_process(job):
    """Rank 0's (2 x 2) checkpoint at round 2, written mid-buffer with
    every in-flight entry gathered whole, resumes in this process in the
    port and in the reference, and lands on the ranks' end within
    1e-5."""
    end, end_meta, ckpt = _check_cut(job, "cut", CUTS["cut"])
    tr = _port_resume(ckpt, CUTS["cut"])
    _close(tr.flat.numpy(), end["params"], "port resume")
    for got, want in zip(tr.history, end_meta["history"]):
        _close(got.train_loss, want["train_loss"], "port resume loss")
    with _ref_trainer(CUTS["cut"]) as ref:
        ref.restore(ckpt)
        assert ref.start_round == task.ASYNC_CUT
        ref.run()
    _close(_ref_flat(ref, tr.layout)[0], end["params"], "reference resume")
    for got, want in zip(ref.history, end_meta["history"]):
        _close(got.train_loss, want["train_loss"], "reference resume loss")


def test_2x2_codec_checkpoint_resumes_on_one_process(job):
    """int8_sr + error feedback: the in-flight payloads (codes, per-leaf
    scales) gathered from the model ranks resume in one process."""
    end, end_meta, ckpt = _check_cut(job, "cut_sr", CUTS["cut_sr"])
    tr = _port_resume(ckpt, CUTS["cut_sr"])
    _close(tr.flat.numpy(), end["params"], "int8_sr resume")
    _close(tr._ef.numpy(), end["ef"], "int8_sr resume ef")
    for got, want in zip(tr.history, end_meta["history"]):
        _close(got.train_loss, want["train_loss"], "int8_sr resume loss")


def test_one_process_checkpoint_resumes_on_4x1(job):
    """A one-process mid-buffer checkpoint resumed on (4 x 1): each
    in-flight entry held by one client slice, the run the uninterrupted
    one within 1e-5."""
    arrays, meta = _load(job, "resumed")
    single, _ = port_single(RESUME_CELL)
    _close(arrays["params"], single.flat.numpy(), "1 -> (4 x 1) resume")
    assert [r["round"] for r in meta["history"]] == list(
        range(task.ASYNC_ROUNDS))
    for got, want in zip(meta["history"][task.ASYNC_CUT:],
                         single.history[task.ASYNC_CUT:]):
        _close(got["train_loss"], want.train_loss, "resume loss")
    held = []
    for rank in range(4):
        with open(os.path.join(job, f"resumed_held_r{rank}")) as fh:
            held.append(int(fh.read()))
    aux = np.load(os.path.join(job, "ckpt1", f"step_{task.ASYNC_CUT:08d}",
                               "aux.npz"))
    assert sum(held) == int(aux["async_n_inflight"]) > 0


def test_cli_async_on_ranks_matches_the_reference_cli(job):
    """The port's CLI on four ranks (--shard-clients --async-buffer
    --model-shards 2, stragglers under ExponentialRuntime) against the
    reference's CLI in one process."""
    with open(os.path.join(job, "ref_cli.json")) as fh:
        want = json.load(fh)
    with open(os.path.join(job, "cli.json")) as fh:
        got = json.load(fh)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g["train_loss"], w["train_loss"], "CLI loss", {
            "rtol": 1e-4, "atol": 1e-6})
        for f in ("comm_bytes_up", "staleness_mean", "staleness_max"):
            assert g[f] == w[f], f
