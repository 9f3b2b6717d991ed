"""Hierarchical edge aggregation in the port, single process, against the
reference at the same numpy inputs: ``masked_client_mean(edges=)``,
every server rule's step with ``edges=2`` (with and without a client
mask, and FedDPC's folds on int8 payloads), the trainer with ``edges=2``
with and without an edge-drop plan on tests/_matrix_task.py's task at
K = 4 (the RoundRecord edge fields equal), the execution regimes' table,
and what the trainer refuses."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _matrix_task as ref_task
import _torch_matrix_task as task
from repro.codec import make_codec as ref_make_codec
from repro.core import api as ref_api
from repro.core import baselines as ref_baselines
from repro.core import feddpc as ref_feddpc
from repro.core import projection as ref_proj
from repro.core.faults import FaultPlan as RefFaultPlan
from repro_torch import bridge
from repro_torch.codec import make_codec
from repro_torch.core import api, baselines, feddpc, projection
from repro_torch.core.faults import FaultPlan
from repro_torch.core.round import ID_SENTINEL
from _torch_threads import one_intra_op_thread  # noqa: F401

K, NUM_CLIENTS, ROUNDS, ETA_G, EDGES = 6, 12, 3, 0.3, 2
RTOL, ATOL = 1e-5, 1e-6
MASKS = {"none": None,
         "ragged": np.array([True, False, True, True, True, False])}
EDGE_FIELDS = ("comm_bytes_up", "comm_bytes_edge_up",
               "comm_bytes_server_up", "edge_dropped")


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def _params(rng):
    return {"w": rng.standard_normal((40, 37), dtype=np.float32),
            "b": rng.standard_normal(37, dtype=np.float32),
            "blocks": [{"c": rng.standard_normal((3, 3, 2, 4),
                                                 dtype=np.float32)}]}


def _rows(tree, n):
    leaves = jax.tree.leaves(tree)
    return np.stack([np.concatenate([np.asarray(x[j]).ravel()
                                     for x in leaves]) for j in range(n)])


def _flat(tree):
    return np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree.leaves(tree)])


@pytest.mark.parametrize("mask", ["none", "ragged"])
@pytest.mark.parametrize("edges", [2, 3])
def test_masked_client_mean_with_edges_matches_reference(edges, mask):
    rng = np.random.default_rng(edges)
    x = rng.standard_normal((K, 37), dtype=np.float32)
    cm = MASKS[mask]
    want = ref_proj.masked_client_mean(
        {"x": jnp.asarray(x)}, None if cm is None else jnp.asarray(cm),
        edges=edges)["x"]
    got = projection.masked_client_mean(
        torch.from_numpy(x), None if cm is None else torch.from_numpy(cm),
        edges=edges)
    _close(got.numpy(), want, f"E={edges}")
    # the two-level mean is the flat one up to summation order
    _close(got.numpy(), projection.masked_client_mean(
        torch.from_numpy(x),
        None if cm is None else torch.from_numpy(cm)).numpy(), "flat")


def _compare_state(state, ref_state):
    assert set(state) == set(ref_state)
    for key, value in ref_state.items():
        if key == "y":
            _close(state[key].numpy(), _rows(value, NUM_CLIENTS), key)
        elif key == "t":
            assert float(state[key]) == float(value)
        else:
            _close(state[key].numpy(), _flat(value), key)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("name", list(ref_baselines.ALGORITHM_NAMES))
def test_rule_step_with_edges_matches_reference(name, mask):
    """Three steps of every rule with edges=2 from the same params,
    deltas and ids: params, every state vector and the diagnostics
    against the reference's edges=2 step (masked rows carry
    ID_SENTINEL, as the deadline and the edge drop hand them over)."""
    rng = np.random.default_rng(1)
    params = _params(rng)
    layout = bridge.layout_of(params)
    cm = MASKS[mask]
    ref_algo = ref_baselines.make_algorithm(name)
    algo = baselines.make_algorithm(name)
    ref_state = ref_algo.init(params, NUM_CLIENTS)
    state = algo.init(layout.flatten(params), NUM_CLIENTS)
    ref_p, p = params, layout.flatten(params)
    for t in range(ROUNDS):
        deltas = jax.tree.map(
            lambda x: rng.standard_normal((K,) + x.shape, dtype=np.float32)
            + 0.5 * x, params)
        ids = rng.choice(NUM_CLIENTS, K, replace=False).astype(np.int32)
        if cm is not None:
            ids[~cm] = ID_SENTINEL
        norm_prev = float(torch.linalg.norm(state["delta_prev"]))
        ref_p, ref_state, ref_diag = ref_algo.step(
            ref_state, ref_p, deltas, jnp.asarray(ids), ETA_G, t,
            client_mask=None if cm is None else jnp.asarray(cm),
            edges=EDGES)
        p, state, diag = algo.step(
            state, p, torch.from_numpy(_rows(deltas, K)),
            torch.from_numpy(ids), ETA_G, t,
            client_mask=None if cm is None else torch.from_numpy(cm),
            edges=EDGES)
        _close(p.numpy(), _flat(ref_p), f"params, round {t}")
        _compare_state(state, ref_state)
        assert set(diag) == set(ref_diag)
        for key, value in ref_diag.items():
            scale = (norm_prev * float(diag["norm_global_update"])
                     if key == "global_dot_prev" else 1.0)
            _close(float(diag[key]), float(value), key, rtol=1e-4,
                   atol=1e-5 * scale)


@pytest.mark.parametrize("mask", list(MASKS))
def test_feddpc_edges_on_int8_payloads_match_reference(mask):
    """FedDPC's fold reads the int8 payload by edge (one dequant fold a
    piece) and lands where the reference's edges=2 step on the decoded
    rows does."""
    rng = np.random.default_rng(2)
    params = _params(rng)
    layout = bridge.layout_of(params)
    cm = MASKS[mask]
    stack = torch.from_numpy(rng.standard_normal((K, layout.size),
                                                 dtype=np.float32))
    codec = make_codec("int8")
    payload = codec.encode_cohort(stack, layout.leaf_offsets)
    decoded = codec.decode_cohort(payload, layout.leaf_offsets)
    prev = torch.from_numpy(rng.standard_normal(layout.size,
                                                dtype=np.float32))
    p = layout.flatten(params)
    mask_t = None if cm is None else torch.from_numpy(cm)
    got_p, got_s, got_d = feddpc.server_step(
        {"delta_prev": prev}, p, decoded, ETA_G, 1.0, client_mask=mask_t,
        encoded=payload, leaf_offsets=layout.leaf_offsets, edges=EDGES)
    ref_codec = ref_make_codec("int8")
    ref_dec = ref_codec.decode_cohort(ref_codec.encode_cohort(
        bridge.to_numpy(layout.unflatten(stack))))
    _close(_rows(ref_dec, K), decoded.numpy(), "decode")
    want_p, want_s, want_d = ref_feddpc.server_step(
        {"delta_prev": bridge.to_numpy(layout.unflatten(prev))}, params,
        ref_dec, ETA_G, 1.0,
        client_mask=None if cm is None else jnp.asarray(cm), edges=EDGES)
    _close(got_p.numpy(), _flat(want_p), "params")
    _close(got_s["delta_prev"].numpy(), _flat(want_s["delta_prev"]),
           "delta_t")
    for key, value in want_d.items():
        # <Δ_t, Δ_prev> is ~0 by construction: held to the f32 scale of
        # its terms, as in test_rule_step_with_edges_matches_reference
        scale = (float(torch.linalg.norm(prev))
                 * float(got_d["norm_global_update"])
                 if key == "global_dot_prev" else 1.0)
        _close(float(got_d[key]), float(value), key, rtol=1e-4,
               atol=1e-5 * scale)


def _ref_trainer(plan=None, **cell_kw):
    return ref_api.FederatedTrainer(
        ref_task.loss_fn, ref_task.make_params(), task.NUM_CLIENTS,
        ref_task.batch_fn,
        ref_api.ExecConfig(rounds=task.ROUNDS, clients_per_round=task.K,
                           seed=task.SEED, eval_every=10 ** 9, **cell_kw),
        algo=ref_api.AlgoConfig(name="feddpc", eta_l=task.ETA_L,
                                eta_g=task.ETA_G),
        fault_plan=None if plan is None else RefFaultPlan.seeded(0, **plan))


@pytest.mark.parametrize("cell", ["feddpc", "feddpc_edge_drop"])
def test_trainer_with_edges_matches_reference(cell):
    """The cohort-vectorized trainer with edges=2 (and an edge drop of
    edge 1 in round 1): losses, params, diagnostics and the RoundRecord
    edge fields against the reference's trainer."""
    _, _, cell_kw, plan = task.CELLS[cell]
    with task.port_trainer(cell) as tr:
        hist = tr.run()
    with _ref_trainer(plan, **cell_kw) as ref:
        ref_hist = ref.run()
    _close(tr.flat.numpy(), bridge.flat_from_reference(
        jax.tree.map(np.asarray, ref.params), tr.layout).numpy(), "params")
    for got, want in zip(hist, ref_hist, strict=True):
        _close(got.train_loss, want.train_loss, "loss")
        assert set(got.diagnostics) == set(want.diagnostics)
        for key, value in want.diagnostics.items():
            _close(got.diagnostics[key], float(value), key, rtol=1e-4,
                   atol=1e-5)
        for f in EDGE_FIELDS:
            assert getattr(got, f) == getattr(want, f), f
    assert [r.edge_dropped for r in hist] == (
        [0, 1, 0] if plan else [0, 0, 0])
    assert hist[0].comm_bytes_server_up == 2 * 4 * tr.layout.size


def test_a_plan_with_edge_drops_and_no_edges_changes_nothing():
    """As in the reference: accepted, and the run is the plain one."""
    plan = {"edge_drop_rounds": (1,), "edge_drop_edges": (1,)}
    with task.port_trainer("feddpc_k3") as plain:
        plain.run()
    tr = api.FederatedTrainer(
        task.loss_fn, task.make_params(), task.NUM_CLIENTS, task.batch_fn,
        api.ExecConfig(rounds=task.ROUNDS, clients_per_round=3,
                       seed=task.SEED, eval_every=10 ** 9),
        algo=api.AlgoConfig(name="feddpc", eta_l=task.ETA_L,
                            eta_g=task.ETA_G),
        fault_plan=FaultPlan.seeded(0, **plan), device="cpu")
    with tr:
        tr.run()
    assert torch.equal(tr.flat, plain.flat)
    assert [r.edge_dropped for r in tr.history] == [0] * task.ROUNDS


def test_exec_regimes_are_the_reference_table():
    assert api.EXEC_REGIMES == ref_api.EXEC_REGIMES


@pytest.mark.parametrize("kw,err,match", [
    ({"edges": 3}, ValueError, "must divide the padded cohort"),
    ({"edges": 2, "async_buffer": True}, ValueError,
     "cannot combine with async_buffer"),
    # the model axis runs, async on it too (tests/test_torch_model_axis.py,
    # tests/test_torch_async_ranks.py); what is left refused: the axis
    # outside a job or without shard_clients (the port's model axis spans
    # ranks), with async_buffer or without
    ({"shard_model": 4, "async_buffer": True}, ValueError,
     "needs shard_clients=True"),
    ({"shard_model": 4}, ValueError, "needs shard_clients=True"),
    ({"shard_model": 2, "shard_clients": True}, ValueError,
     "in a multi-process job"),
])
def test_trainer_refuses(kw, err, match):
    with pytest.raises(err, match=match):
        task.port_trainer("feddpc", **kw)


# ---- the cross-silo round (round.make_fl_round_step) ----

@pytest.mark.parametrize("name", ["feddpc", "fedavg"])
def test_fl_round_step_matches_reference(name):
    """Two rounds of the cross-silo round on the matrix task (K = 4
    silos, 2 all-valid minibatches each): params, Δ_prev and metrics
    against the reference's raw round_step."""
    from repro.core.round import make_fl_round_step as ref_make
    from repro_torch.core.round import make_fl_round_step
    rng = np.random.RandomState(3)
    batches = {"x": rng.randn(4, 2, 8, 8).astype(np.float32),
               "y": rng.randn(4, 2, 8, 4).astype(np.float32)}
    params = task.make_params()
    layout = bridge.layout_of(params)
    ref_step = jax.jit(ref_make(ref_task.loss_fn, task.ETA_L, task.ETA_G,
                                0.7, name))
    step = make_fl_round_step(task.loss_fn, layout, task.ETA_L, task.ETA_G,
                              0.7, name)
    ref_p, ref_dp = params, jax.tree.map(np.zeros_like, params)
    p, dp = layout.flatten(params), torch.zeros(layout.size)
    for _ in range(2):
        norm_prev = float(torch.linalg.norm(dp))
        ref_p, ref_dp, ref_m = ref_step(ref_p, ref_dp, batches)
        p, dp, m = step(p, dp, bridge.to_torch(batches))
        _close(p.numpy(), _flat(ref_p), "params")
        _close(dp.numpy(), _flat(ref_dp), "delta_prev")
        assert set(m) == set(ref_m)
        for key, value in ref_m.items():
            # <Δ_t, Δ_prev> is ~0: held to the f32 scale of its terms
            scale = (norm_prev * float(torch.linalg.norm(dp))
                     if key == "global_dot_prev" else 1.0)
            _close(float(m[key]), float(value), key, rtol=1e-4,
                   atol=1e-5 * scale)


def test_fl_round_step_refuses_stateful_rules_and_specs_match():
    from repro.core.round import fl_round_input_specs as ref_specs
    from repro_torch.core.round import (fl_round_input_specs,
                                        make_fl_round_step)
    with pytest.raises(ValueError, match="exactly {'delta_prev'}"):
        make_fl_round_step(task.loss_fn, None, 0.1, 1.0,
                           algorithm="fedvarp")
    kw = dict(clients=4, local_steps=3, local_batch=2, seq_len=17)
    got = fl_round_input_specs(None, **kw)
    want = ref_specs(None, **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(v.shape)
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype)
