"""The MoE layer on the port's ranks, on the CPU: tensor-parallel experts
(models/moe.py with ``tp``) and the expert-parallel all-to-all MoE
(models/moe_ep.py) on a (data, model) mesh, held against the reference.

Two gloo jobs (tests/_torch_moe_parallel_worker.py, spawned by
launch/distributed.spawn_local: a pair for the (1 x 2) cells, a quad
for M = 4 and the (2 x 2) mesh) run at once, while this process runs
the reference's functions on the same numpy inputs and Kimi-K2 SMOKE's
reference init:

  (i)   the reference's three tests/test_moe_ep.py cases on the port:
        moe_forward_ep on a 1 x 1 make_debug_mesh against the reference's
        (Kimi-K2 SMOKE's output and aux; DeepSeek-V2 SMOKE's gradients
        without shared experts), and on the (2 x 2) mesh against the
        reference's moe_forward (output; aux at groups = 2), at capacity
        factor 8 and the reference's tolerances;
  (ii)  the tensor-parallel MoE layer at M = 2 and 4 against the
        reference's moe_forward at the config's capacity factor (1.25,
        where assignments drop): output, aux and every leaf's gradient;
  (iii) make_train_step over a model group of 2 and the expert-parallel
        step on (2 x 2), both at capacity factor 8, against the
        reference's one-process make_train_step;
  (iv)  a federated FedDPC run of Kimi-K2 SMOKE on the trainer's
        tensor-parallel route, (1 x 2), K = 4, against both packages'
        one-process runs;
  (v)   the leaf classes and a rank's expert bytes at full size, and what
        still refuses.
"""
import functools
import json
import os
import re
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_moe_parallel_worker as w
from repro.configs.base import get_config as ref_get_config
from repro.core import api as ref_api
from repro.launch import steps as ref_steps
from repro.launch import train as ref_train
from repro.launch.mesh import make_debug_mesh as ref_debug_mesh
from repro.models import moe as ref_moe
from repro.models import moe_ep as ref_moe_ep
from repro.models import transformer as ref_tf
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.launch import distributed, mesh as mesh_mod, steps
from repro_torch.models import moe_ep
from repro_torch.models import transformer as tf
from repro_torch.sharding.layout import (PARTIAL, VIEW, ShardLayout,
                                         tp_classes)
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_moe_parallel_worker.py")
RTOL, ATOL = 1e-5, 1e-6
MOVE_FRAC = 1e-2        # a leaf's error against how far the steps moved it


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("moe_parallel"))
    env = {"PYTHONPATH": os.path.join(ROOT, "src")}
    failures = []

    def spawn(n):
        try:
            distributed.spawn_local([sys.executable, WORKER, "--out", out],
                                    n, timeout_s=300, env=env)
        except RuntimeError as e:
            failures.append(e)
    threads = [threading.Thread(target=spawn, args=(n,))
               for n in (w.PAIR, w.QUAD)]
    for t in threads:
        t.start()
    try:
        # the port's run first: after a JAX compile its CPU kernels share
        # the cores with XLA's threads and run several times slower
        port_serial()
        ref_layer()
        ref_steps_run()
        ref_serial()
    finally:
        for t in threads:
            t.join(360)
    assert not any(t.is_alive() for t in threads)
    if failures:
        raise failures[0]
    return out


def _load(out, tag, rank):
    return dict(np.load(os.path.join(out, f"{tag}_r{rank}.npz")))


def _close(got, want, what, tol=None):
    np.testing.assert_allclose(got, want, err_msg=what,
                               **(tol or {"rtol": RTOL, "atol": ATOL}))


def _ref_cfg(**kw):
    return ref_get_config(w.ARCH, smoke=True).with_(**kw)


def _ref_layer_params(cfg):
    return {"mlp": ref_moe.init_moe(jax.random.PRNGKey(w.SEED), cfg,
                                    jnp.float32)}


# ---------------- (i) the reference's moe_ep cases ----------------

def test_single_shard_ep_matches_the_references():
    """Kimi-K2 SMOKE at capacity factor 8: the port's moe_forward_ep on a
    1 x 1 mesh (this process, no collective) against the reference's on
    make_debug_mesh(1, 1), output within 2e-4 and aux equal."""
    rcfg = _ref_cfg(capacity_factor=8.0)
    p = ref_moe.init_moe(jax.random.PRNGKey(0), rcfg, jnp.float32)
    x = np.random.RandomState(1).randn(2, 8, rcfg.d_model).astype(
        np.float32)
    want, want_aux = jax.jit(lambda pp, xx: ref_moe_ep.moe_forward_ep(
        rcfg, pp, xx, mesh=ref_debug_mesh(1, 1)))(p, jnp.asarray(x))
    mesh = mesh_mod.make_debug_mesh(1, 1)
    assert isinstance(mesh, mesh_mod.LocalMesh)
    got, aux = moe_ep.moe_forward_ep(
        get_config(w.ARCH, smoke=True).with_(capacity_factor=8.0),
        bridge.to_torch(jax.tree.map(np.asarray, p)), torch.from_numpy(x),
        mesh=mesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert np.isclose(float(aux), float(want_aux))


def test_single_shard_ep_gradients_match_the_reference():
    """DeepSeek-V2 SMOKE without shared experts, capacity factor 8: every
    leaf's gradient of sum(out) within 5e-4 of the reference's."""
    kw = dict(capacity_factor=8.0, num_shared_experts=0)
    rcfg = ref_get_config("deepseek-v2-236b", smoke=True).with_(**kw)
    p = ref_moe.init_moe(jax.random.PRNGKey(0), rcfg, jnp.float32)
    x = np.random.RandomState(2).randn(1, 8, rcfg.d_model).astype(
        np.float32)
    want = jax.jit(jax.grad(lambda pp: ref_moe_ep.moe_forward_ep(
        rcfg, pp, jnp.asarray(x), mesh=ref_debug_mesh(1, 1))[0].sum()))(p)
    cfg = get_config("deepseek-v2-236b", smoke=True).with_(**kw)
    tree = bridge.to_torch(jax.tree.map(np.asarray, p))
    leaves = [t.requires_grad_(True) for t in bridge.tree_leaves(tree)]
    out, _ = moe_ep.moe_forward_ep(cfg, tree, torch.from_numpy(x),
                                   mesh=mesh_mod.make_debug_mesh(1, 1))
    got = torch.autograd.grad(out.sum(), leaves)
    for g, wl in zip(got, jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wl), rtol=5e-4,
                                   atol=5e-4)


def test_ep_on_a_2x2_mesh_matches_the_gshard_layer(job):
    """moe_forward_ep on the (2 x 2) gloo mesh, each data rank on its rows,
    against the reference's moe_forward on the whole input: output within
    3e-4, aux within rtol 1e-4 of the groups = 2 aux (each expert shard's
    tokens a group); the two model ranks of a data row agree bit for bit
    and each holds (E/2, D, F/2) of an expert stack."""
    rcfg = _ref_cfg(capacity_factor=w.EP_CF)
    p = _ref_layer_params(rcfg)["mlp"]
    x, _ = w.layer_inputs(w.EP_B, w.EP_S, rcfg.d_model)
    fwd = jax.jit(ref_moe.moe_forward, static_argnums=(0,),
                  static_argnames=("groups",))
    want, _ = fwd(rcfg, p, jnp.asarray(x))
    _, want_aux = fwd(rcfg, p, jnp.asarray(x), groups=2)
    got = [_load(job, "ep_layer", r) for r in range(4)]
    for r, g in enumerate(got):
        assert list(g["coords"]) == [r // 2, r % 2]
        assert tuple(g["expert_shape"]) == (rcfg.num_experts // 2,
                                            rcfg.d_model, rcfg.moe_d_ff // 2)
        np.testing.assert_array_equal(g["out"], got[r - r % 2]["out"])
        assert np.isclose(float(g["aux"]), float(want_aux), rtol=1e-4)
    out = np.concatenate([got[0]["out"], got[2]["out"]])
    np.testing.assert_allclose(out, np.asarray(want), rtol=3e-4, atol=3e-4)


# ---------------- (ii) tensor-parallel experts ----------------

@functools.lru_cache(maxsize=None)
def ref_layer():
    """The reference's moe_forward on the layer's input at the config's
    capacity factor: out, aux and the gradient of sum(out * proj) + aux
    as the port's flat vector, and the slot capacity."""
    rcfg = _ref_cfg()
    params = _ref_layer_params(rcfg)
    x, proj = (jnp.asarray(a) for a in w.layer_inputs(
        w.LAYER_B, w.LAYER_S, rcfg.d_model))

    def loss(pp):
        out, aux = ref_moe.moe_forward(rcfg, pp["mlp"], x)
        return (out * proj).sum() + aux, (out, aux)
    (_, (out, aux)), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    layout = bridge.layout_of(jax.tree.map(np.asarray, params))
    flat = bridge.flat_from_reference(jax.tree.map(np.asarray, grad),
                                      layout).numpy()
    cap = ref_moe.capacity_per_group(rcfg, w.LAYER_B * w.LAYER_S)
    return np.asarray(out), float(aux), flat, layout, cap


@pytest.mark.parametrize("model", [2, 4])
def test_tp_layer_matches_the_reference(job, model):
    """Kimi-K2 SMOKE's MoE layer (4 experts + 1 shared, top-2, 64 tokens
    at capacity factor 1.25: assignments drop) tensor-parallel over M
    ranks against the reference's moe_forward: every rank routes the same
    expert ids, the output and aux within rtol 1e-5, and each rank's
    gradient of every leaf — the experts' ffn slices, the shared experts'
    Megatron slices, the router's whole gradient (summed over the group)
    — within 1e-5 of the gradient's max."""
    want_out, want_aux, want_grad, layout, cap = ref_layer()
    shards = ShardLayout.from_sizes(layout, {"clients": 1, "model": model})
    got = [_load(job, f"tp_layer{model}", r) for r in range(model)]
    counts = np.bincount(got[0]["idx"].reshape(-1), minlength=4)
    assert counts.max() > cap, (counts, cap)          # drops included
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["idx"], got[0]["idx"])
        _close(g["out"], want_out, f"rank {r} out",
               {"rtol": RTOL, "atol": RTOL * np.abs(want_out).max()})
        _close(float(g["aux"]), want_aux, f"rank {r} aux")
        want = shards.scatter(torch.from_numpy(want_grad), r).numpy()
        _close(g["grad"], want, f"rank {r} grads",
               {"rtol": 0, "atol": RTOL * float(np.abs(want_grad).max())})
        classes = dict(zip(("/".join(map(str, p)) for p in layout.paths),
                           g["classes"]))
        assert classes["mlp/router/w"] == PARTIAL
        for leaf in ("gate", "up", "down", "shared/gate/w", "shared/up/w",
                     "shared/down/w"):
            assert classes[f"mlp/{leaf}"] == VIEW, leaf


# ---------------- (iii) the train steps ----------------

@functools.lru_cache(maxsize=None)
def ref_steps_run():
    """The reference's one-process make_train_step (remat="full") on its
    init at EP_CF with the aux of two token groups (the (2 x 2) mesh's two
    expert shards; the TP step routes so too). Returns (the params as the
    port's flat vector, the losses, the initial flat vector, the
    layout)."""
    cfg = _ref_cfg(capacity_factor=w.EP_CF)
    step = jax.jit(ref_steps.make_train_step(
        cfg, lr=w.STEP_LR, remat="full", moe_groups=2))
    params = ref_tf.init_lm(cfg, jax.random.PRNGKey(w.SEED), jnp.float32)
    layout = bridge.layout_of(jax.tree.map(np.asarray, params))
    start = bridge.flat_from_reference(jax.tree.map(np.asarray, params),
                                       layout).numpy()
    batch = jax.tree.map(jnp.asarray, w.step_batch())
    losses = []
    for _ in range(w.STEPS):
        params, loss = step(params, batch)
        losses.append(float(loss))
    end = bridge.flat_from_reference(jax.tree.map(np.asarray, params),
                                     layout).numpy()
    return end, losses, start, layout


def _check_steps(shards, ranks, what):
    """Losses within 1e-5 of the reference's on every rank; the gathered
    params within rtol 1e-5 / atol 1e-6, and each leaf within MOVE_FRAC
    of how far the reference's steps moved it."""
    want, want_losses, start, layout = ref_steps_run()
    for g in ranks:
        _close(g["losses"], want_losses, f"{what} losses", {"rtol": RTOL})
    full = shards.gather([torch.from_numpy(g["shard"])
                          for g in ranks]).numpy()
    for r, g in enumerate(ranks):
        np.testing.assert_array_equal(
            g["shard"], shards.scatter(torch.from_numpy(full), r).numpy())
    for i, path in enumerate(layout.paths):
        a, b = int(layout.leaf_offsets[i]), int(layout.leaf_offsets[i + 1])
        err = np.abs(full[a:b] - want[a:b]).max()
        move = np.abs(want[a:b] - start[a:b]).max()
        assert err <= MOVE_FRAC * move or err <= ATOL, (path, err, move)
        _close(full[a:b], want[a:b], f"{what} leaf {path}")


def test_tp_train_step_matches_the_reference(job):
    """Two SGD steps of make_train_step(remat="full") over a model group of
    2 on Kimi-K2 SMOKE (its MoE layer tensor-parallel: the experts'
    ffn dim split, the router's gradient summed, the aux loss once) at
    capacity factor 8 in 2 token groups, against the reference's
    one-process step."""
    layout = ref_steps_run()[3]
    shards = ShardLayout.from_sizes(layout, {"clients": 1, "model": 2})
    _check_steps(shards, [_load(job, "tp_step", r) for r in range(2)],
                 "tp step")


def test_ep_train_step_matches_the_reference(job):
    """Two SGD steps of make_train_step(moe_impl="ep", moe_mesh=(2 x 2)) at
    capacity factor 8 — each data rank on its 2 rows, its 2 experts' ffn
    halves, the all-to-alls' backward bringing each expert every rank's
    cotangents, the other leaves' gradients summed over the data group —
    against the reference's one-process step (groups = 2)."""
    layout = ref_steps_run()[3]
    shards = ShardLayout.for_experts(layout, 2, 2)
    ranks = [_load(job, "ep_step", r) for r in range(4)]
    _check_steps(shards, ranks, "ep step")
    # a rank's expert stacks at rest: E/2 experts x F/2 columns
    cfg = get_config(w.ARCH, smoke=True)
    expert = [i for i, p in enumerate(layout.paths)
              if re.search(r"mlp/(gate|up|down)$", "/".join(map(str, p)))]
    for r in range(4):
        held = dict(shards.held(r))
        assert sum(int(np.prod(held[i])) for i in expert) == \
            3 * cfg.num_experts * cfg.d_model * cfg.moe_d_ff // 4


def test_ep_loss_on_one_process_is_the_gshard_loss():
    """On a 1 x 1 mesh without a job, loss_fn(moe_impl="ep") and the
    expert-parallel train step equal the GShard ones at capacity factor 8
    (nothing drops): losses within 1e-5, the steps' params within 1e-5."""
    cfg = get_config(w.ARCH, smoke=True).with_(capacity_factor=8.0)
    from repro_torch.core import jax_prng
    params = tf.init_lm(cfg, jax_prng.PRNGKey(w.SEED), torch.float32)
    batch = w._t(w.step_batch())
    mesh = mesh_mod.make_debug_mesh(1, 1)
    want = tf.loss_fn(cfg, params, batch)
    got = tf.loss_fn(cfg, params, batch, moe_impl="ep", moe_mesh=mesh)
    _close(float(got), float(want), "loss")
    layout = bridge.layout_of(params)
    step = steps.make_train_step(cfg, lr=w.STEP_LR, remat="none",
                                 moe_impl="ep", moe_mesh=mesh)
    shard, loss = step(step.shards.scatter(layout.flatten(params), 0), batch)
    want_params, want_loss = steps.make_train_step(
        cfg, lr=w.STEP_LR, remat="none")(params, batch)
    _close(float(loss), float(want_loss), "step loss")
    _close(shard.numpy(), layout.flatten(want_params).numpy(), "params")


# ---------------- (iv) the federated round ----------------

@functools.lru_cache(maxsize=None)
def port_serial():
    with w.trainer(sharded=False, vectorize=False) as tr:
        tr.run()
    return tr


@functools.lru_cache(maxsize=None)
def ref_serial():
    params, loss_fn, source, _, _ = ref_train.build_lm_task(w.lm_args())
    with ref_api.FederatedTrainer(
            loss_fn, params, w.CLIENTS, source,
            ref_api.ExecConfig(**w.exec_kw(sharded=False), vectorize=False),
            algo=ref_api.AlgoConfig(name="feddpc", eta_l=w.ETA_L,
                                    eta_g=w.ETA_G)) as tr:
        tr.run()
    return tr


def _delta_tol(params):
    """Δ = (w_{t-1} − w)/η_l: an ulp of w, where the model ranks' sums
    round otherwise than one process's, is ulp/η_l in Δ."""
    eps = float(np.finfo(np.float32).eps)
    return {"rtol": RTOL, "atol": max(
        ATOL, 4 * eps * float(np.abs(params).max()) / w.ETA_L)}


@pytest.mark.parametrize("against", ["port", "reference"])
def test_federated_tp_round_matches_one_process(job, against):
    """The trainer's tensor-parallel route on (1 x 2) — both model ranks
    train the slice's 4 rows on their shards, one feddpc_dots and one
    feddpc_batched_epilogue a rank a round, no params all-gather nor
    all-to-all — against one process's run of either package: params,
    Δ_prev and the round losses within rtol 1e-5."""
    arrays = [_load(job, "fed", r) for r in range(2)]
    metas = []
    for r in range(2):
        with open(os.path.join(job, f"fed_r{r}.json")) as fh:
            metas.append(json.load(fh))
    serial = port_serial()
    if against == "port":
        want_p = serial.flat.numpy()
        want_s = {k: v.numpy() for k, v in serial.server_state.items()}
        hist = [(h.train_loss, h.comm_bytes_up) for h in serial.history]
    else:
        ref = ref_serial()
        want_p = bridge.flat_from_reference(
            jax.tree.map(np.asarray, ref.params), serial.layout).numpy()
        want_s = {k: v.numpy() for k, v in
                  bridge.server_state_from_reference(
                      jax.tree.map(np.asarray, ref.server_state),
                      serial.layout).items()}
        hist = [(h.train_loss, h.comm_bytes_up) for h in ref.history]
    for r, (a, meta) in enumerate(zip(arrays, metas)):
        _close(a["params"], want_p, f"rank {r} params")
        for k, v in want_s.items():
            _close(a[f"state_{k}"], v, f"rank {r} {k}", _delta_tol(want_p))
        got = [(h["train_loss"], h["comm_bytes_up"]) for h in
               meta["history"]]
        assert len(got) == len(hist)
        for (gl, gb), (wl, wb) in zip(got, hist):
            _close(gl, wl, "loss")
            assert gb == wb
        assert meta["shard"]["route"] == "tensor_parallel"
        assert meta["calls"] == {"feddpc_dots": w.ROUNDS,
                                 "feddpc_batched_epilogue": w.ROUNDS}
        names = {n for rd in meta["collectives"] for n in rd}
        assert not names & {"param_all_gather", "all_to_all"}, names
        assert {"tp_leaf_gather", "tp_all_reduce"} <= names
    np.testing.assert_array_equal(arrays[0]["params"], arrays[1]["params"])


# ---------------- (v) classes at full size, refusals ----------------

@pytest.mark.parametrize("model", [2, 4])
def test_kimi_classes_and_expert_bytes_at_full_size(model):
    """Kimi-K2 at full width (61 layers, 384 experts, moe_d_ff 2048, meta
    tensors) on the cohort layout of M model ranks: the expert stacks and
    the shared experts are VIEW, the router PARTIAL, and a rank's expert
    stacks at rest are E·3·D·F/M × 4 bytes a MoE layer."""
    cfg = get_config(w.ARCH)
    assert tf.tensor_parallel_refusal(cfg) is None
    assert tf.LMLoss(cfg).tensor_parallel
    layout = bridge.layout_of(steps.params_spec(cfg))
    shards = ShardLayout.from_sizes(layout, {"clients": 1, "model": model})
    classes = tp_classes(shards, cfg.resolved_head_dim)
    paths = ["/".join(map(str, p)) for p in layout.paths]
    expert = [i for i, p in enumerate(paths)
              if re.search(r"mlp/(gate|up|down)$", p)]
    assert expert
    for i, p in enumerate(paths):
        if i in expert or re.search(r"shared/(gate|up|down)/w$", p):
            assert classes[i] == VIEW, p
        elif re.search(r"router/w$", p):
            assert classes[i] == PARTIAL, p
    moe_layers = cfg.num_layers - cfg.first_dense_layers
    for m in range(model):
        held = dict(shards.held(m))
        got = 4 * sum(int(np.prod(held[i])) for i in expert)
        assert got == moe_layers * 4 * (
            cfg.num_experts * 3 * cfg.d_model * cfg.moe_d_ff // model)


@pytest.mark.parametrize("arch,item", [
    ("deepseek-v2-236b", "13f"), ("jamba-1.5-large-398b", "13g")])
def test_moe_families_still_refused_cite_their_items(arch, item):
    cfg = get_config(arch, smoke=True)
    assert not tf.LMLoss(cfg).tensor_parallel
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        steps.make_train_step(cfg, model_group=object())


def test_serving_with_ep_and_the_production_mesh_refuse():
    """Serving takes no "ep" (item 13i: serving over ranks); the dry-run's
    production mesh is item 15; a mesh wider than one process needs a
    job."""
    cfg = get_config(w.ARCH, smoke=True)
    shape = type("S", (), {"long_context": False, "seq_len": 8,
                           "global_batch": 1})()
    for make in (steps.make_prefill_step, steps.make_decode_step):
        with pytest.raises(NotImplementedError, match="item 13i"):
            make(cfg, shape, moe_impl="ep")
    with pytest.raises(NotImplementedError, match="item 15"):
        mesh_mod.make_production_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_debug_mesh(2, 2)
