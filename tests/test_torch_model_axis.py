"""The port's model axis on the CPU.

One four-process gloo job (tests/_torch_model_axis_worker.py, spawned by
launch/distributed.spawn_local) runs every cell of
_torch_matrix_task.MODEL_CELLS — the five ``*2d`` regimes for FedDPC on a
(1 x 4) and a (2 x 2) (clients, model) mesh, FedAvg and FedVARP
``sharded2d`` on both, guarded FedDPC with a fault plan and int8_sr on
(2 x 2) — and this process holds each against the port's and the
reference's serial runs (params, server state, losses and diagnostics
within rtol 1e-5 and atol 1e-6; the codec cells against the reference's
within its CODEC_TOL, against the port's at 1e-5 too), every rank against the others bitwise on what is replicated,
each rank's shards against the gathered vectors, prefetch on against
off bitwise, the kernels each rank calls against its rows, a (2 x 2)
checkpoint resumed on one process by both packages, a one-process
checkpoint resumed on (2 x 2), and the training CLI with --model-shards
2 against the reference CLI.

In this process: the ported rules (sharding/rules.py) against the
reference's specs on its test trees and on the full-size shapes of
ResNet18-GN, StarCoder2-3B, DeepSeek-V2, Jamba-1.5 and Kimi-K2;
ShardLayout's scatter and gather bit for bit; int8_sr's blocks bit for
bit the reference's whole-stack codes restricted to each block."""
import functools
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

import _matrix_task as ref_task
import _torch_matrix_task as task
from repro.codec import make_codec as ref_make_codec
from repro.configs.base import get_config as ref_get_config
from repro.configs.shapes import InputShape as RefInputShape
from repro.core import api as ref_api
from repro.core.faults import FaultPlan as RefFaultPlan
from repro.launch import steps as ref_steps
from repro.models.vision import init_vision as ref_init_vision
from repro.sharding import rules as ref_rules
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.codec import make_codec
from repro_torch.core import api, jax_prng
from repro_torch.core.round import make_fl_round_step
from repro_torch.kernels.int8_sr import ops as sr_ops
from repro_torch.launch import distributed, steps
from repro_torch.sharding import rules
from repro_torch.sharding.layout import ShardLayout
from repro_torch.sharding.rules import P
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_model_axis_worker.py")
RTOL, ATOL = 1e-5, 1e-6
# the reference's codec bounds (tests/_regime_matrix_check.py CODEC_TOL;
# importing that module would force 8 host devices on this process)
CODEC_TOL = {"int8": dict(rtol=1e-1, atol=2e-2),
             "int8_sr": dict(rtol=2e-1, atol=5e-2)}
CUT = 2
RESUME_CELL = "feddpc:sharded2d:2"
CELLS = list(task.MODEL_CELLS)


# ---------------- the four-rank job ----------------

@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The job's dumps: a one-process checkpoint at round 2 for the ranks
    to resume, then the four ranks' runs. While the ranks run, the
    reference's CLI runs in a process of its own and this process runs
    the serial runs of both packages."""
    out = str(tmp_path_factory.mktemp("model_axis"))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", *task.CLI_ARGS,
         "--out", os.path.join(out, "ref_cli.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        with task.model_trainer(RESUME_CELL, sharded=False) as tr:
            for t in range(CUT):
                tr.run_round(t)
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
                port_serial(_serial_key(cell))
                ref_serial(_serial_key(cell))
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


def _serial_key(cell):
    """What a cell's serial run depends on: the rule, the codec, the
    server optimizer, the guard and the fault plan."""
    name, kw, plan = task.model_cell_kw(cell, sharded=False)
    return (name, kw.get("codec"), kw.get("server_opt"),
            bool(kw.get("guard")), None if plan is None
            else tuple(sorted(plan.items())))


def _serial_cfg(key, module):
    name, codec, sopt, guard, _ = key
    kw = {"codec": codec, "server_opt": sopt, "guard": guard}
    return module.ExecConfig(rounds=task.ROUNDS, clients_per_round=task.K,
                             seed=task.SEED, eval_every=10 ** 9,
                             vectorize=False, **kw)


@functools.lru_cache(maxsize=None)
def port_serial(key):
    from repro_torch.core.faults import FaultPlan
    name, _, _, _, plan = key
    with api.FederatedTrainer(
            task.loss_fn, task.make_params(), task.NUM_CLIENTS,
            task.batch_fn, _serial_cfg(key, api),
            algo=api.AlgoConfig(name=name, eta_l=task.ETA_L,
                                eta_g=task.ETA_G),
            fault_plan=(None if plan is None
                        else FaultPlan.seeded(0, **dict(plan))),
            device="cpu") as tr:
        tr.run()
    return tr


@functools.lru_cache(maxsize=None)
def ref_serial(key):
    name, _, _, _, plan = key
    with ref_api.FederatedTrainer(
            ref_task.loss_fn, ref_task.make_params(), task.NUM_CLIENTS,
            ref_task.batch_fn, _serial_cfg(key, ref_api),
            algo=ref_api.AlgoConfig(name=name, eta_l=task.ETA_L,
                                    eta_g=task.ETA_G),
            fault_plan=(None if plan is None
                        else RefFaultPlan.seeded(0, **dict(plan)))) as tr:
        tr.run()
    return tr


def _ref_flat(tr, layout):
    params = bridge.flat_from_reference(
        jax.tree.map(np.asarray, tr.params), layout).numpy()
    state = {k: v.numpy() for k, v in bridge.server_state_from_reference(
        jax.tree.map(np.asarray, tr.server_state), layout).items()}
    return params, state


def _tol(cell):
    codec = task.model_cell_kw(cell)[1].get("codec")
    return CODEC_TOL[codec] if codec else {"rtol": RTOL, "atol": ATOL}


def _close(got, want, what, tol=None):
    np.testing.assert_allclose(got, want, err_msg=what,
                               **(tol or {"rtol": RTOL, "atol": ATOL}))


def _check_run(arrays, meta, want_params, want_state, want_hist, what,
               tol=None):
    _close(arrays["params"], want_params, f"{what}: params", tol)
    assert {k[6:] for k in arrays if k.startswith("state_")} == \
        set(want_state), what
    for k, v in want_state.items():
        _close(arrays[f"state_{k}"], v, f"{what}: state {k}", tol)
    hist = meta["history"]
    assert len(hist) == len(want_hist), what
    for got, want in zip(hist, want_hist):
        _close(got["train_loss"], want.train_loss, f"{what}: loss", tol)
        assert set(got["diagnostics"]) == set(want.diagnostics), what
        for key, v in want.diagnostics.items():
            _close(got["diagnostics"][key], float(v), f"{what}: {key}", tol)
        for f in ("comm_bytes_up", "quarantined", "clipped"):
            assert got[f] == getattr(want, f), (what, f, got[f])


@pytest.mark.parametrize("cell", CELLS)
def test_model_cells_match_the_serial_runs(job, cell):
    arrays, meta = _load(job, cell)
    serial = port_serial(_serial_key(cell))
    assert meta["schedule"] == [s.tolist() for s in
                                serial.state().schedule]
    _check_run(arrays, meta, serial.flat.numpy(),
               {k: v.numpy() for k, v in serial.server_state.items()},
               serial.history, f"{cell} vs the port's serial run")
    ref = ref_serial(_serial_key(cell))
    params, state = _ref_flat(ref, serial.layout)
    _check_run(arrays, meta, params, state, ref.history,
               f"{cell} vs the reference's serial run", _tol(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_ranks_agree_and_hold_only_their_shards(job, cell):
    """Every rank gathers the same params and state and records the same
    history, bit for bit; each holds at rest only its shard of the
    params, the state and the moments (N_m columns, Σ_m N_m = N), equal
    to the gathered vectors' shard, and the ranks of one model
    coordinate hold the same shard."""
    m_size = task.MODEL_CELLS[cell][2]
    arrays0, meta0 = _load(job, cell)
    layout = bridge.layout_of(task.make_params())
    shards = ShardLayout.from_sizes(layout, {"clients": 4 // m_size,
                                             "model": m_size})
    sizes = []
    for rank in range(4):
        arrays, meta = _load(job, cell, rank)
        m = rank % m_size
        info = meta["shard"]
        assert info["mesh"] == [4 // m_size, m_size]
        assert info["coords"] == [rank // m_size, m]
        assert info["N"] == layout.size and info["N_m"] == shards.sizes[m]
        sizes.append(info["N_m"])
        for k in arrays0:
            if not k.startswith("shard_"):
                np.testing.assert_array_equal(arrays[k], arrays0[k],
                                              err_msg=(cell, rank, k))
        assert _replicated(meta) == _replicated(meta0), (cell, rank)
        full = lambda a: torch.from_numpy(a)
        np.testing.assert_array_equal(
            arrays["shard_params"],
            shards.scatter(full(arrays["params"]), m).numpy())
        for k in [k for k in arrays if k.startswith("shard_state_")]:
            name = k[len("shard_state_"):]
            want = arrays[f"state_{name}"]
            if want.ndim:
                assert arrays[k].shape == want.shape[:-1] + (info["N_m"],)
                np.testing.assert_array_equal(
                    arrays[k], shards.scatter(full(want), m).numpy())
                assert info["bytes"]["server_state"][name] == \
                    arrays[k].nbytes
        for k in [k for k in arrays if k.startswith("shard_opt_")]:
            assert arrays[k].shape == (info["N_m"],)
        assert info["bytes"]["params"] == 4 * info["N_m"]
        if rank >= m_size:
            other, _ = _load(job, cell, rank - m_size)
            np.testing.assert_array_equal(arrays["shard_params"],
                                          other["shard_params"])
    assert sum(sizes[:m_size]) == layout.size


@pytest.mark.parametrize("m", [4, 2])
def test_staged2d_prefetch_on_and_off_agree_bitwise(job, m):
    cell = f"feddpc:staged2d:{m}"
    for rank in range(4):
        on, meta = _load(job, cell, rank)
        off, off_meta = _load(job, cell + ":noprefetch", rank)
        assert set(on) == set(off)
        for k in on:
            np.testing.assert_array_equal(off[k], on[k], err_msg=(rank, k))
        assert _replicated(off_meta) == _replicated(meta)


def _replicated(meta):
    """A run's history without its host-clock fields (each rank's
    own)."""
    return [{k: v for k, v in r.items() if "seconds" not in k}
            for r in meta["history"]]


def _expected_calls(cell):
    """Per round on every rank: one reduction pass (the guard's under the
    guard) over the slice's rows and one fold (the dequant fold with a
    codec), int8_sr's encode once; the FedAvg family none."""
    name, kw, _ = task.model_cell_kw(cell)
    if name != "feddpc":
        return {}
    per = {"feddpc_guard_dots" if kw.get("guard") else "feddpc_dots": 1}
    per["feddpc_dequant_batched_epilogue" if kw.get("codec")
        else "feddpc_batched_epilogue"] = 1
    if kw.get("codec") == "int8_sr":
        per["int8_sr_quantize"] = 1
    return {k: task.ROUNDS * v for k, v in per.items()}


@pytest.mark.parametrize("cell", CELLS)
def test_each_rank_calls_the_kernels_and_collectives_its_rows_imply(job,
                                                                    cell):
    name, kw, _ = task.model_cell_kw(cell)
    want = ["param_all_gather", "all_to_all"]
    if kw.get("codec"):
        want.append("leaf_extrema")
    want += ["model_sum", "all_gather",
             "all_gather" if name == "fedvarp" else "all_reduce",
             "model_sum"]
    m_size = task.MODEL_CELLS[cell][2]
    slice_rows = task.K // (4 // m_size)
    for rank in range(4):
        _, meta = _load(job, cell, rank)
        assert meta["calls"] == _expected_calls(cell), (rank, meta["calls"])
        assert meta["collectives"] == [want] * task.ROUNDS
        lo, hi = meta["shard"]["slice_rows"]
        assert (lo, hi) == ((rank // m_size) * slice_rows,
                            (rank // m_size + 1) * slice_rows)
        assert meta["shard"]["train_rows"] == list(
            rules.model_row_split(lo, hi, m_size)[rank % m_size])


def test_2d_checkpoint_resumes_on_one_process(job):
    """Rank 0's (2 x 2) checkpoint at round 2 resumes in this process, in
    the port and in the reference, and lands on the ranks' end."""
    end, end_meta = _load(job, "cut")
    ckpt = os.path.join(job, "ckpt2d")
    with open(os.path.join(ckpt, f"step_{CUT:08d}", "aux.json")) as fh:
        assert json.load(fh)["exec_mesh"] == {
            "shard_clients": True, "shard_model": 2, "devices": 4}
    tr = task.model_trainer(RESUME_CELL, sharded=False)
    tr.restore(ckpt)
    assert tr.start_round == CUT
    with tr:
        tr.run()
    _close(tr.flat.numpy(), end["params"], "port resume")
    _close(tr.history[-1].train_loss,
           end_meta["history"][-1]["train_loss"], "port resume loss")
    name, kw, _ = task.model_cell_kw(RESUME_CELL, sharded=False)
    ref = ref_api.FederatedTrainer.resume(
        ckpt, ref_task.loss_fn, ref_task.make_params(), task.NUM_CLIENTS,
        ref_task.batch_fn,
        ref_api.ExecConfig(rounds=task.ROUNDS, clients_per_round=task.K,
                           seed=task.SEED, eval_every=10 ** 9, **kw),
        algo=ref_api.AlgoConfig(name=name, eta_l=task.ETA_L,
                                eta_g=task.ETA_G))
    assert ref.start_round == CUT
    with ref:
        ref.run()
    _close(_ref_flat(ref, tr.layout)[0], end["params"], "reference resume")
    _close(ref.history[-1].train_loss,
           end_meta["history"][-1]["train_loss"], "reference resume loss")


def test_one_process_checkpoint_resumes_on_2x2(job):
    arrays, meta = _load(job, "resumed")
    serial = port_serial(_serial_key(RESUME_CELL))
    _close(arrays["params"], serial.flat.numpy(), "1 -> (2 x 2) resume")
    assert [r["round"] for r in meta["history"]] == list(range(task.ROUNDS))
    assert len(meta["collectives"]) == task.ROUNDS - CUT


def test_cli_with_model_shards_matches_the_reference_cli(job):
    """The port's CLI on four ranks (--shard-clients --model-shards 2
    --edges 2) against the reference's CLI (--edges 2, one process)."""
    with open(os.path.join(job, "ref_cli.json")) as fh:
        want = json.load(fh)
    with open(os.path.join(job, "cli.json")) as fh:
        got = json.load(fh)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g["train_loss"], w["train_loss"], "CLI loss", {
            "rtol": 1e-4, "atol": 1e-6})
        for f in ("comm_bytes_up", "comm_bytes_edge_up",
                  "comm_bytes_server_up", "edge_dropped"):
            assert g[f] == w[f], f


@pytest.mark.parametrize("name", ["feddpc", "fedavg"])
def test_fl_round_step_on_2x2_matches_one_process(job, name):
    """make_fl_round_step on the (2 x 2) mesh (params and delta_prev as
    shards, each rank its share of the silos) against its one-process
    round and the reference's raw round_step: two rounds."""
    from repro.core.round import make_fl_round_step as ref_make
    got = [dict(np.load(os.path.join(job, f"fl_round_r{r}.npz")))
           for r in range(4)]
    for g in got[1:]:
        assert set(g) == set(got[0])
        for k in g:
            np.testing.assert_array_equal(g[k], got[0][k], err_msg=k)
    got = got[0]
    params = task.make_params()
    layout = bridge.layout_of(params)
    step = make_fl_round_step(task.loss_fn, layout, task.ETA_L, task.ETA_G,
                              0.7, name)
    ref_step = jax.jit(ref_make(ref_task.loss_fn, task.ETA_L, task.ETA_G,
                                0.7, name))
    batches = task.fl_batches()
    p, dp = layout.flatten(params), torch.zeros(layout.size)
    ref_p, ref_dp = params, jax.tree.map(np.zeros_like, params)
    for t in range(2):
        p, dp, m = step(p, dp, batches)
        ref_p, ref_dp, ref_m = ref_step(ref_p, ref_dp, bridge.to_numpy(
            batches))
        for want_p, want_dp in ((p.numpy(), dp.numpy()),
                                (bridge.flat_from_reference(
                                    jax.tree.map(np.asarray, ref_p),
                                    layout).numpy(),
                                 bridge.flat_from_reference(
                                    jax.tree.map(np.asarray, ref_dp),
                                    layout).numpy())):
            _close(got[f"{name}_{t}_params"], want_p, "params")
            _close(got[f"{name}_{t}_dp"], want_dp, "delta_prev")
        keys = {k[len(f"{name}_{t}_m_"):] for k in got
                if k.startswith(f"{name}_{t}_m_")}
        assert keys == set(m) == set(ref_m)
        for k in keys:
            tol = ({"rtol": 1e-4, "atol": 1e-5 * float(
                torch.linalg.norm(dp)) ** 2} if k == "global_dot_prev"
                else None)
            _close(float(got[f"{name}_{t}_m_{k}"]), float(m[k]), k, tol)


# ---------------- the rules, in this process ----------------

class _FakeCohortMesh:
    """Shape-only (2 clients x 4 model) mesh, the reference's idiom."""
    axis_names = ("clients", "model")
    mesh_dim_names = None

    class devices:
        shape = (2, 4)


class _FakeDataMesh:
    axis_names = ("data", "model")
    mesh_dim_names = None

    class devices:
        shape = (2, 4)


def _as_meta(tree):
    return jax.tree.map(lambda x: torch.empty(tuple(x.shape),
                                              device="meta"), tree)


def _spec_list(tree, ref):
    if ref:
        return [tuple(s) for s in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, RefP))]
    return [tuple(s) for s in rules.spec_leaves(tree)]


def _same(got, want):
    assert _spec_list(got, False) == _spec_list(want, True)


def _test_trees():
    """The reference's test trees (tests/test_sharding.py) and odd
    leaves."""
    z = lambda *s: np.zeros(s, np.float32)
    return {
        "dense": {"wq": {"w": z(16, 32)}, "w1": z(8, 16), "b1": z(16),
                  "odd": z(7, 9), "head": {"w": z(6, 4)}, "scalar": z()},
        "lm": {"embed": z(64, 16), "lm_head": {"w": z(16, 64)},
               "layers": [{"wq": {"w": z(16, 16), "b": z(16)},
                           "wo": {"w": z(16, 16)},
                           "mlp": {"gate": z(4, 16, 8), "down": z(4, 8, 16),
                                   "router": {"w": z(16, 4)}},
                           "in_proj": {"w": z(16, 32)}, "a_log": z(8, 4),
                           "d_skip": z(6)}]},
        "matrix": {k: np.asarray(v) for k, v in
                   ref_task.make_params().items()},
    }


def _full_size_trees():
    """Shapes only: the reference's trees and the port's meta trees."""
    out = {}
    vcfg = ref_get_config("resnet18-gn")
    shapes = jax.eval_shape(lambda k: ref_init_vision(vcfg, k),
                            jax.random.PRNGKey(0))
    out["resnet18-gn"] = (_as_meta(shapes), shapes)
    for arch in ("starcoder2-3b", "deepseek-v2-236b",
                 "jamba-1.5-large-398b", "kimi-k2-1t-a32b"):
        out[arch] = (steps.params_spec(get_config(arch)),
                     ref_steps.params_spec(ref_get_config(arch)))
    return out


TREES = list(_test_trees())
FULL = ("resnet18-gn", "starcoder2-3b", "deepseek-v2-236b",
        "jamba-1.5-large-398b", "kimi-k2-1t-a32b")


@functools.lru_cache(maxsize=None)
def _full(arch):
    return _full_size_trees()[arch]


def _pair(name):
    if name in FULL:
        return _full(name)
    tree = _test_trees()[name]
    return tree, tree


@pytest.mark.parametrize("name", TREES + list(FULL))
def test_cohort_specs_equal_the_references(name):
    got_tree, want_tree = _pair(name)
    mesh = _FakeCohortMesh()
    _same(rules.cohort_param_specs(got_tree, mesh),
          ref_rules.cohort_param_specs(want_tree, mesh))
    # a server state: a mirror, a per-client table and a scalar
    if name not in FULL or name == "resnet18-gn":
        got_s = {"delta_prev": got_tree, "t": np.zeros(()),
                 "y": bridge.tree_map(lambda x: torch.empty(
                     (3,) + tuple(x.shape), device="meta"), got_tree)}
        want_s = {"delta_prev": want_tree, "t": np.zeros(()),
                  "y": jax.tree.map(lambda x: jax.ShapeDtypeStruct(
                      (3,) + tuple(x.shape), jnp.float32), want_tree)}
        _same(rules.cohort_state_specs(got_s, got_tree, mesh),
              ref_rules.cohort_state_specs(want_s, want_tree, mesh))


@pytest.mark.parametrize("name", TREES + list(FULL))
def test_param_specs_equal_the_references(name):
    got_tree, want_tree = _pair(name)
    mesh = _FakeDataMesh()
    _same(rules.param_specs(got_tree, mesh),
          ref_rules.param_specs(want_tree, mesh))
    pol = rules.ShardingPolicy(batch_axes=("data",), fsdp_dense=True)
    ref_pol = ref_rules.ShardingPolicy(batch_axes=("data",),
                                       fsdp_dense=True)
    _same(rules.param_specs(got_tree, mesh, pol),
          ref_rules.param_specs(want_tree, mesh, ref_pol))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "jamba-1.5-large-398b",
                                  "deepseek-v2-236b"])
def test_state_and_batch_specs_equal_the_references(arch):
    mesh = _FakeDataMesh()
    shape, rshape = (InputShape("t", 64, 8, "decode"),
                     RefInputShape("t", 64, 8, "decode"))
    _same(rules.state_specs(steps.states_spec(get_config(arch), shape),
                            mesh),
          ref_rules.state_specs(ref_steps.states_spec(
              ref_get_config(arch), rshape), mesh))
    for b in (8, 6, 1):
        batch = {"tokens": np.zeros((b, 16), np.int32),
                 "frames": np.zeros((b, 4, 3), np.float32),
                 "idx": np.zeros((), np.int32)}
        _same(rules.batch_specs(batch, mesh),
              ref_rules.batch_specs(batch, mesh))


def test_leaf_spec_equals_the_references():
    pol, rpol = rules.ShardingPolicy(), ref_rules.ShardingPolicy()
    sizes = {"data": 2, "model": 4}
    cases = [("layers/0/wq/w", (16, 32)), ("layers/0/wq/w", (16, 30)),
             ("stack/0/mlp/gate", (2, 8, 16, 32)), ("x/conv_b", (8,)),
             ("x/mlp/router/w", (64, 8)), ("embed", (100, 16)),
             ("norm/scale", (16,)), ("lm_head/w", (16, 64)), ("s", ())]
    for path, shape in cases:
        assert tuple(rules._leaf_spec(path, shape, pol, sizes)) == \
            tuple(ref_rules._leaf_spec(path, shape, rpol, sizes)), path
    tp = rules.ShardingPolicy(expert_axis=("clients", "data"))
    rtp = ref_rules.ShardingPolicy(expert_axis=("clients", "data"))
    sizes3 = {"clients": 2, "data": 2, "model": 4}
    assert tuple(rules._leaf_spec("mlp/up", (8, 16, 32), tp, sizes3)) == \
        tuple(ref_rules._leaf_spec("mlp/up", (8, 16, 32), rtp, sizes3))


@pytest.mark.parametrize("name", ["dense", "matrix", "resnet18-gn"])
def test_round_shardings_and_payload_specs_equal_the_references(name):
    """The two-axis shardings' specs are the reference's spec functions'
    (its NamedShardings need a real mesh of 8 devices); the 1-D ones the
    reference's on a real one-device mesh; both raise without
    templates."""
    got_tree, want_tree = _pair(name)
    mesh = _FakeCohortMesh()
    state = {"delta_prev": got_tree}
    rstate = {"delta_prev": want_tree}
    p_want = ref_rules.cohort_param_specs(want_tree, mesh)
    s_want = ref_rules.cohort_state_specs(rstate, want_tree, mesh)
    (s_in, p_in, b_in, m_in, i_in), (p_out, s_out, l_out, d_out) = \
        rules.cohort_round_shardings(mesh, params=got_tree,
                                     server_state=state)
    spec_of = lambda named: rules.map_specs(lambda s: s, jax.tree.map(
        lambda n: n.spec, named, is_leaf=lambda x: isinstance(
            x, rules.NamedSharding)))
    _same(spec_of(p_in), p_want)
    _same(spec_of(s_out), s_want)
    assert tuple(b_in.spec) == ("clients",) and tuple(d_out.spec) == ()
    _same(rules.codec_payload_specs(rules.cohort_param_specs(got_tree,
                                                             mesh),
                                    "clients"),
          ref_rules.codec_payload_specs(p_want, "clients"))
    wave_in, wave_out, fold_in, fold_out = rules.async_round_shardings(
        mesh, params=got_tree, server_state=state, codec_payload=True)
    _same(spec_of(fold_in[2]),
          ref_rules.codec_payload_specs(p_want, None))
    _same(spec_of(wave_out[0]),
          ref_rules.codec_payload_specs(p_want, "clients"))
    with pytest.raises(ValueError, match="templates"):
        rules.cohort_round_shardings(mesh)
    with pytest.raises(ValueError, match="templates"):
        ref_rules.cohort_round_shardings(mesh)
    one = jax.make_mesh((1,), ("clients",))
    got1 = rules.cohort_round_shardings(one)
    want1 = ref_rules.cohort_round_shardings(one)
    assert [[tuple(x.spec) for x in side] for side in got1] == \
        [[tuple(x.spec) for x in side] for side in want1]
    got_a = rules.async_round_shardings(one)
    want_a = ref_rules.async_round_shardings(one)
    assert [[tuple(x.spec) for x in side] for side in got_a] == \
        [[tuple(x.spec) for x in side] for side in want_a]


def test_to_named_gives_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _FakeCohortMesh()
    named = rules.to_named({"w": P(None, "model"), "b": P("model"),
                            "s": P(), "t": P(("clients", "model"))}, mesh)
    assert named["w"].placements == (Replicate(), Shard(1))
    assert named["b"].placements == (Replicate(), Shard(0))
    assert named["s"].placements == (Replicate(), Replicate())
    assert named["t"].placements == (Shard(0), Shard(0))
    assert rules.mesh_axes(mesh) == {"clients": 2, "model": 4}


@pytest.mark.parametrize("model", [2, 4])
def test_shard_layout_gathers_the_full_vector_bitwise(model):
    """Every element is in exactly one shard: replicated leaves ((7, 9),
    a scalar) on model rank 0 alone, sharded leaves split on their
    spec's dim; gather, scatter and the padded all-gather's unpad give
    the full vector back bit for bit, and the shards' leaf offsets leave
    out the leaves a shard holds nothing of."""
    tree = _test_trees()["dense"]
    layout = bridge.layout_of(tree)
    sl = ShardLayout.from_mesh(layout, type(
        "M", (), {"axis_names": ("clients", "model"),
                  "mesh_dim_names": None,
                  "devices": type("D", (), {"shape": (4 // model,
                                                      model)})})())
    full = torch.randn(3, layout.size, generator=torch.Generator()
                       .manual_seed(model))
    shards = [sl.scatter(full, m) for m in range(model)]
    assert torch.equal(sl.gather(shards), full)
    # into rows of a wider stack, as the all-to-all writes its own rows
    into = torch.zeros(5, sl.sizes[model - 1])
    sl.scatter(full, model - 1, out=into[1:4])
    assert torch.equal(into[1:4], shards[-1]) and not into[0].any()
    pad = torch.zeros(3, model, sl.max_size)
    for m, s in enumerate(shards):
        pad[:, m, :s.shape[1]] = s
    assert torch.equal(sl.unpad(pad), full)
    assert sum(sl.sizes) == layout.size
    order = [rules.path_str(p) for p in layout.paths]
    for m in range(model):
        offs = sl.offsets(m)
        assert bool((offs[1:] > offs[:-1]).all())
        held = [order[i] for i in sl.leaf_ids(m)]
        assert ("odd" in held) == (m == 0) and ("scalar" in held) == (m == 0)
        # the w1 (8, 16) slice on dim 1: rows of 16 / model columns
        w1 = layout.paths.index(("w1",))
        start = int(layout.leaf_offsets[w1])
        want = np.arange(128).reshape(8, 16)[:, m * 16 // model:
                                             (m + 1) * 16 // model].ravel()
        i = list(sl.leaf_ids(m)).index(w1)
        index = sl.scatter(torch.arange(layout.size), m).numpy()
        got = index[int(offs[i]):int(offs[i + 1])] - start
        np.testing.assert_array_equal(got, want)
        # int8_sr's slice descriptor gives the same within-leaf positions
        numel, inner, stride, base = sl.leaf_blocks(m)[i].tolist()
        p = np.arange(int(offs[i + 1] - offs[i]))
        assert numel == 128
        np.testing.assert_array_equal(
            p // inner * stride + base + p % inner, want)


# ---------------- int8_sr's blocks ----------------

def _sr_stack(k, seed=0):
    """A (k, ...) client stack over the dense test tree's shapes, a NaN in
    one row, with the reference's int8_sr codes and scales of the whole
    stack."""
    rng = np.random.default_rng(seed)
    tree = {name: rng.standard_normal((k,) + x.shape).astype(np.float32)
            for name, x in _test_trees()["dense"].items()
            if not isinstance(x, dict)}
    tree["wq"] = {"w": rng.standard_normal((k, 16, 32)).astype(np.float32)}
    tree["head"] = {"w": rng.standard_normal((k, 6, 4)).astype(np.float32)}
    tree["w1"][1, 2, 3] = np.nan
    key = jax.random.fold_in(jax.random.PRNGKey(7), 2)
    payload = ref_make_codec("int8_sr").encode_cohort(
        jax.tree.map(jnp.asarray, tree), key=key)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(payload["q"])]
    scales = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        payload["scale"])]
    flat = np.concatenate([x.reshape(k, -1) for x in
                           jax.tree_util.tree_leaves(tree)], 1)
    layout = bridge.layout_of(jax.tree.map(lambda x: x[0], tree))
    return (torch.from_numpy(flat), layout,
            np.concatenate([q.reshape(k, -1) for q in leaves], 1),
            torch.from_numpy(np.stack(scales, 1)),
            jax_prng.fold_in(jax_prng.PRNGKey(7), 2))


@pytest.mark.parametrize("layout_name,k,clients,model", [
    ("1d", 6, 2, 1), ("2x2", 4, 2, 2), ("2x2_odd_rows", 6, 2, 2)])
def test_int8_sr_blocks_are_the_whole_stacks_codes(layout_name, k, clients,
                                                   model):
    """Each rank's block — rows of its client slice (and on the model
    axis its shard's columns of every leaf it holds) — drawn with the
    block arguments is bitwise the reference's whole-stack codes
    restricted to the block; so is the codec's encode through a rank's
    shard with the whole leaves' extrema."""
    flat, layout, want_q, want_s, key = _sr_stack(k)
    sl = ShardLayout.from_sizes(layout, {"clients": clients,
                                         "model": model})
    per = k // clients
    for c in range(clients):
        rows = slice(c * per, (c + 1) * per)
        for m in range(model):
            idx = sl.scatter(torch.arange(layout.size), m).numpy()
            ids = sl.leaf_ids(m)
            x = sl.scatter(flat[rows], m)
            block = {"row0": c * per, "rows_total": k}
            if model > 1:
                block["leaf_blocks"] = sl.leaf_blocks(m)
            got = sr_ops.int8_sr_quantize(
                x, want_s[rows][:, ids].contiguous(), sl.offsets(m),
                jax_prng.fold_in_many(key, ids), **block)
            np.testing.assert_array_equal(
                got.numpy(), want_q[rows][:, idx],
                err_msg=(layout_name, c, m))
            # through the codec, the extrema taken over the whole leaves
            shard = _StubShard(c * per, k, model, m, sl, flat[rows])
            payload = make_codec("int8_sr").encode_cohort(
                x, sl.offsets(m), key=key, shard=shard)
            np.testing.assert_array_equal(payload["q"].numpy(),
                                          want_q[rows][:, idx])
            np.testing.assert_array_equal(payload["scale"].numpy(),
                                          want_s[rows][:, ids].numpy())


class _StubShard:
    """A rank's RankShard as the codec sees it, its model-axis extrema
    taken from the whole rows in this process."""

    def __init__(self, lo, rows, model, mrank, shards, whole):
        self.lo, self.rows, self.model, self.mrank = lo, rows, model, mrank
        self.shards, self.whole = shards, whole

    def leaf_extrema(self, mn, mx):
        offs = self.shards.layout.leaf_offsets.tolist()
        ids = self.shards.leaf_ids(self.mrank)
        x = self.whole
        amax = torch.stack([x[:, offs[i]:offs[i + 1]].abs().amax(1)
                            for i in ids], 1)
        return amax, amax


def test_int8_sr_block_split_counter_layout():
    """The split-counter layout's size is the whole stack's: a block with
    row0 and rows_total draws the same bits as rows of the whole draw."""
    flat, layout, _, _, key = _sr_stack(6, seed=1)
    offs = layout.leaf_offsets
    scale = torch.ones((6, offs.numel() - 1))
    keys = jax_prng.fold_in_many(key, np.arange(offs.numel() - 1))
    whole = sr_ops.int8_sr_quantize(flat, scale, offs, keys,
                                    partitionable=False)
    part = sr_ops.int8_sr_quantize(flat[3:5].contiguous(), scale[3:5]
                                   .contiguous(), offs, keys,
                                   partitionable=False, row0=3,
                                   rows_total=6)
    assert torch.equal(part, whole[3:5])
    with pytest.raises(ValueError, match="outside the stack"):
        sr_ops.int8_sr_quantize(flat[3:5].contiguous(), scale[3:5]
                                .contiguous(), offs, keys, row0=5,
                                rows_total=6)


def test_fl_round_step_needs_a_template_on_the_model_axis():
    layout = bridge.layout_of(task.make_params())
    with pytest.raises(ValueError, match="params_template"):
        make_fl_round_step(task.loss_fn, layout, 0.1, 1.0,
                           mesh=_FakeCohortMesh())
