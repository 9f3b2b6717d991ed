"""Tensor-parallel local training on the port's model axis, on the CPU.

Two gloo jobs (tests/_torch_tp_worker.py, spawned by
launch/distributed.spawn_local; a trainer's mesh spans its job, so the
(1 x 2) cells need a job of two ranks and the (2 x 2) and (1 x 4) cells
one of four) run at once, while this process runs both packages'
one-process runs of the same cells. Held against the reference, inputs
from numpy seeds, weights carried by ``bridge``:

  (i)   launch/steps.make_train_step over a model group of 2 and of 4
        ranks (StarCoder2 SMOKE: 4 query heads on 2 KV heads, so at M = 4
        wk/wv are whole on every rank and their gradient is summed)
        against the reference's one-device step: both losses, every
        gathered leaf, each rank's shard bit for bit the scatter of the
        gathered vector;
  (ii)  the trainer on the LM task, FedDPC lam = 1, K = 2, on (1 x 2),
        (2 x 2) and (1 x 4) (client slices of fewer rows than model
        ranks) against the port's and the reference's serial runs; no
        param_all_gather or all_to_all;
  (iii) make_fl_round_step on (1 x 2) against the reference's raw round
        (mesh=None);
  (iv)  an async int8 + error-feedback cell on (1 x 2), and a TP round's
        checkpoint resumed in one process;
  (v)   the TP view's leaf classes at full size (StarCoder2-3B and the
        ~101M LM example at M = 2 and 4), and the families that once
        refused (MLA, Mamba, the encoder-decoder) on their route.
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

import _torch_tp_worker as w
from repro.configs.base import get_config as ref_get_config
from repro.core import api as ref_api
from repro.core.round import make_fl_round_step as ref_make_fl_round_step
from repro.core.runtime import ExponentialRuntime as RefExponentialRuntime
from repro.launch import steps as ref_steps
from repro.launch import train as ref_train
from repro.models import transformer as ref_tf
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.launch import distributed, steps
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf
from repro_torch.sharding import layout as layout_mod
from repro_torch.sharding.layout import (PARTIAL, VIEW, WHOLE, ShardLayout,
                                         tp_classes)
from _torch_one_rank import check_tp_route
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_tp_worker.py")
RTOL, ATOL = 1e-5, 1e-6
EPS = float(np.finfo(np.float32).eps)
SYNC = [c for c, v in w.CELLS.items() if not v[3]]
ASYNC = [c for c, v in w.CELLS.items() if v[3]]
# an int8 code may flip where a delta sits within rounding of a code
# boundary: the ranks' sums run in another order than one process's
CODE_FLIP_FRACTION = 1e-3


# ---------------- the two jobs ----------------

@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tensor_parallel"))
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
        for cell in w.CELLS:
            port_serial(cell)
            ref_serial(cell)
        ref_train_steps()
    finally:
        for t in threads:
            t.join(360)
    assert not any(t.is_alive() for t in threads)
    if failures:
        raise failures[0]
    return out


def _load(out, tag, rank=0):
    arrays = dict(np.load(os.path.join(out, f"{tag}_r{rank}.npz")))
    path = os.path.join(out, f"{tag}_r{rank}.json")
    if not os.path.exists(path):
        return arrays, None
    with open(path) as fh:
        return arrays, json.load(fh)


def _one_process_key(cell):
    """What a cell's one-process run depends on (cells share it)."""
    return tuple(sorted(w.exec_kw(cell, sharded=False).items()))


_PORT = {}


def port_serial(cell):
    """The cell's run in one process: sync cells on the serial
    (per-client) path, async ones on the cohort path (the engine's)."""
    key = _one_process_key(cell)
    if key not in _PORT:
        more = {} if w.CELLS[cell][3] else {"vectorize": False}
        with w.trainer(cell, sharded=False, **more) as tr:
            tr.run()
        _PORT[key] = tr
    return _PORT[key]


def ref_serial(cell):
    return _ref_serial(_one_process_key(cell))


@functools.lru_cache(maxsize=None)
def _ref_serial(key):
    params, loss_fn, source, _, _ = ref_train.build_lm_task(w.lm_args())
    kw = dict(key)
    if not kw.get("async_buffer"):
        kw["vectorize"] = False
    with ref_api.FederatedTrainer(
            loss_fn, params, w.CLIENTS, source, ref_api.ExecConfig(**kw),
            algo=ref_api.AlgoConfig(name="feddpc", eta_l=w.ETA_L,
                                    eta_g=w.ETA_G),
            runtime=(RefExponentialRuntime(mean=1.0)
                     if kw.get("async_buffer") else None)) as tr:
        tr.run()
    return tr


@functools.lru_cache(maxsize=None)
def ref_train_steps():
    """The reference's one-device make_train_step on its init: the
    losses and the params after w.STEPS steps (numpy leaves)."""
    cfg = ref_get_config(w.ARCH, smoke=True)
    step = jax.jit(ref_steps.make_train_step(cfg, lr=w.STEP_LR,
                                             remat="none"))
    params = ref_tf.init_lm(cfg, jax.random.PRNGKey(w.SEED), jnp.float32)
    batch = jax.tree.map(jnp.asarray, w.step_batch())
    losses = []
    for _ in range(w.STEPS):
        params, loss = step(params, batch)
        losses.append(float(loss))
    return jax.tree.map(np.asarray, params), losses


def _ref_flat(tr, layout):
    params = bridge.flat_from_reference(
        jax.tree.map(np.asarray, tr.params), layout).numpy()
    state = {k: v.numpy() for k, v in bridge.server_state_from_reference(
        jax.tree.map(np.asarray, tr.server_state), layout).items()}
    return params, state


def _close(got, want, what, tol=None):
    np.testing.assert_allclose(got, want, err_msg=what,
                               **(tol or {"rtol": RTOL, "atol": ATOL}))


def _delta_tol(params):
    """Δ = (w_{t-1} − w)/η_l: an ulp of w, where the model ranks' sums
    round otherwise than one process's, is ulp/η_l in Δ."""
    return {"rtol": RTOL, "atol": max(
        ATOL, 4 * EPS * float(np.abs(params).max()) / w.ETA_L)}


def _codes_close(got, want, what, step):
    """Within RTOL/ATOL but for at most CODE_FLIP_FRACTION of the
    elements, which may differ by one int8 quantization step of the
    largest leaf."""
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert bad.mean() <= CODE_FLIP_FRACTION, (what, int(bad.sum()))
    assert np.all(np.abs(got - want)[bad] <= step), what


def _check_run(cell, arrays, meta, want_params, want_state, want_hist,
               what):
    codec = w.CELLS[cell][3].get("codec")
    step = 2 * float(np.abs(want_params).max()) / 255 if codec else None
    if codec:
        _codes_close(arrays["params"], want_params, f"{what}: params", step)
    else:
        _close(arrays["params"], want_params, f"{what}: params")
    assert {k[6:] for k in arrays if k.startswith("state_")} == \
        set(want_state), what
    state_tol = _delta_tol(want_params)
    for k, v in want_state.items():
        if codec:
            _codes_close(arrays[f"state_{k}"], v, f"{what}: {k}", step)
        else:
            _close(arrays[f"state_{k}"], v, f"{what}: state {k}",
                   state_tol)
    hist = meta["history"]
    assert len(hist) == len(want_hist), what
    prev = 0.0
    for got, want in zip(hist, want_hist):
        _close(got["train_loss"], want.train_loss, f"{what}: loss")
        diag = {k: float(v) for k, v in want.diagnostics.items()}
        assert set(got["diagnostics"]) == set(diag), what
        for key, v in diag.items():
            _close(got["diagnostics"][key], v, f"{what}: {key}",
                   {"rtol": 1e-4 if codec else RTOL,
                    "atol": _diag_atol(key, diag, prev)})
        prev = diag.get("norm_global_update", 0.0)
        assert got["comm_bytes_up"] == want.comm_bytes_up, what


def _diag_atol(key, diag, prev_norm):
    """A dot's rounding scales with the norms it multiplies, not with
    the dot (Cauchy-Schwarz): <Δ_t, Δ_{t-1}> is held to RTOL times
    ‖Δ_t‖‖Δ_{t-1}‖, a cosine to RTOL, a projection coefficient
    <Δ_j, Δ_{t-1}>/‖Δ_{t-1}‖² to RTOL times ‖Δ_j‖/‖Δ_{t-1}‖; every other
    diagnostic to ATOL besides its RTOL."""
    if key == "global_dot_prev":
        return max(ATOL, RTOL * diag["norm_global_update"] * prev_norm)
    if key == "mean_cos_angle":
        return RTOL
    if key == "mean_coef" and prev_norm:
        return max(ATOL, RTOL * diag["mean_norm_delta"] / prev_norm)
    return ATOL


def _job_ranks(cell):
    return w.CELLS[cell][0]


# ---------------- (i) the one-client train step ----------------

@pytest.mark.parametrize("model", [2, 4])
def test_train_step_over_a_model_group_matches_the_reference(job, model):
    """Two SGD steps of make_train_step(remat="full") over M ranks against
    the reference's one-device step: losses within rtol 1e-5, every leaf
    of the gathered params within rtol 1e-5 / atol 1e-6. At M = 4 the 2
    KV heads are whole on every rank (PARTIAL: their gradient summed over
    the group), the LayerNorms whole on every rank (WHOLE: kept
    unsummed) — swapping the two rules fails here."""
    want, want_losses = ref_train_steps()
    layout = bridge.layout_of(tf.init_lm(get_config(w.ARCH, smoke=True),
                                         "meta", torch.float32))
    shards = ShardLayout.from_sizes(layout, {"clients": 1, "model": model})
    got = [dict(np.load(os.path.join(job, f"step{model}_r{r}.npz")))
           for r in range(model)]
    for g in got:
        _close(g["losses"], want_losses, "losses")
        np.testing.assert_array_equal(g["params"], got[0]["params"])
    for m, g in enumerate(got):
        np.testing.assert_array_equal(
            g["shard"], shards.scatter(torch.from_numpy(g["params"]),
                                       m).numpy())
    leaves = layout.unflatten(torch.from_numpy(got[0]["params"]))
    for (path, g), wl in zip(bridge.tree_leaves_with_path(leaves),
                             jax.tree.leaves(want)):
        _close(g.numpy(), wl, f"leaf {path}")


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("arch", w.DENSE)
def test_dense_families_grads_match_one_process(job, arch, model):
    """Every dense family's SMOKE loss and cohort gradient (vmap over 2
    rows) tensor-parallel over M ranks against one process's on the same
    rank, its shard's columns: losses within rtol 1e-5, gradients within
    1e-5 of their max (tied embeddings, SwiGLU, squared ReLU, RMSNorm,
    the VLM's patch prefix; at M = 4 the SMOKE configs' 2 KV heads are
    whole on every rank)."""
    for rank in range(model):
        got = dict(np.load(os.path.join(job, f"dense{model}_r{rank}.npz")))
        _close(got[f"{arch}_loss"], got[f"{arch}_want_loss"], "loss")
        want = got[f"{arch}_want_grad"]
        _close(got[f"{arch}_grad"], want, f"{arch} rank {rank} grads",
               {"rtol": 0, "atol": RTOL * float(np.abs(want).max())})


# ---------------- (ii) the trainer ----------------

@pytest.mark.parametrize("cell", SYNC + ASYNC)
def test_tp_cells_match_the_serial_runs(job, cell):
    arrays, meta = _load(job, cell)
    serial = port_serial(cell)
    _check_run(cell, arrays, meta, serial.flat.numpy(),
               {k: v.numpy() for k, v in serial.server_state.items()},
               serial.history, f"{cell} vs the port's one-process run")
    params, state = _ref_flat(ref_serial(cell), serial.layout)
    _check_run(cell, arrays, meta, params, state, ref_serial(cell).history,
               f"{cell} vs the reference's one-process run")


@pytest.mark.parametrize("cell", SYNC + ASYNC)
def test_tp_ranks_agree_and_hold_only_their_shards(job, cell):
    """Every rank gathers the same params and state, bit for bit, and
    holds at rest its shard of them: the scatter of the gathered vectors
    (N_m columns, summing to N over a model group)."""
    ranks, model = _job_ranks(cell), w.CELLS[cell][1]
    arrays0, meta0 = _load(job, cell)
    shards = ShardLayout.from_sizes(port_serial(cell).layout,
                                    {"clients": ranks // model,
                                     "model": model})
    for rank in range(ranks):
        arrays, meta = _load(job, cell, rank)
        m = rank % model
        assert meta["shard"]["coords"] == [rank // model, m]
        for k in arrays0:
            if not k.startswith("shard_"):
                np.testing.assert_array_equal(arrays[k], arrays0[k],
                                              err_msg=(cell, rank, k))
        np.testing.assert_array_equal(
            arrays["shard_params"],
            shards.scatter(torch.from_numpy(arrays["params"]), m).numpy())
        for k in [k for k in arrays if k.startswith("shard_state_")]:
            want = arrays["state_" + k[len("shard_state_"):]]
            if want.ndim:
                np.testing.assert_array_equal(
                    arrays[k],
                    shards.scatter(torch.from_numpy(want), m).numpy())
    assert sum(shards.sizes) == shards.layout.size


@pytest.mark.parametrize("cell", SYNC + ASYNC)
def test_tp_rounds_train_every_row_on_every_model_rank(job, cell):
    """The tensor-parallel route: every model rank trains the client
    slice's rows (a slice with fewer rows than M trains), the round
    issues no param_all_gather and no all_to_all but the model group's
    tp_leaf_gather and tp_all_reduce, every rank of the job issues the
    same collectives in the same order, and each round (or fold) makes
    one reduction pass and one fold launch."""
    ranks, model, k, more = w.CELLS[cell]
    slices = ranks // model
    per = -(-k // slices)
    logs = []
    for rank in range(ranks):
        _, meta = _load(job, cell, rank)
        info = meta["shard"]
        assert info["route"] == "tensor_parallel"
        c = rank // model
        assert info["slice_rows"] == [c * per, (c + 1) * per]
        assert info["train_rows"] == info["slice_rows"]
        assert info["N_m"] < info["N"]
        names = {n for r in meta["collectives"] for n in r}
        assert not names & {"param_all_gather", "all_to_all"}, names
        assert {"tp_leaf_gather", "tp_all_reduce", "model_sum"} <= names
        logs.append(meta["collectives"])
        if not more:
            fold = "feddpc_batched_epilogue"
            assert meta["calls"] == {"feddpc_dots": w.ROUNDS,
                                     fold: w.ROUNDS}, meta["calls"]
    assert all(log == logs[0] for log in logs)
    if cell in ("tp:2x2", "tp:1x4"):
        assert per < model


# ---------------- (iii) the cross-silo round step ----------------

def test_fl_round_step_on_1x2_matches_the_reference(job):
    """make_fl_round_step on the (1 x 2) mesh — each silo a
    model-parallel replica, both model ranks stepping the slice's silos
    on their shards — against the reference's raw round_step
    (mesh=None): params, delta_prev and metrics of two rounds."""
    got = [dict(np.load(os.path.join(job, f"fl_round_r{r}.npz")))
           for r in range(2)]
    for k in got[0]:
        np.testing.assert_array_equal(got[1][k], got[0][k], err_msg=k)
    got = got[0]
    cfg = ref_get_config(w.ARCH, smoke=True)
    params = ref_tf.init_lm(cfg, jax.random.PRNGKey(w.SEED), jnp.float32)
    layout = bridge.layout_of(jax.tree.map(np.asarray, params))
    step = jax.jit(ref_make_fl_round_step(
        lambda p, b: ref_tf.loss_fn(cfg, p, b), w.ETA_L, w.ETA_G, 1.0,
        "feddpc"))
    dp = jax.tree.map(jnp.zeros_like, params)
    batches = jax.tree.map(jnp.asarray, w.fl_batches())
    for t in range(2):
        params, dp, metrics = step(params, dp, batches)
        _close(got[f"{t}_params"], bridge.flat_from_reference(
            jax.tree.map(np.asarray, params), layout).numpy(), "params")
        _close(got[f"{t}_dp"], bridge.flat_from_reference(
            jax.tree.map(np.asarray, dp), layout).numpy(), "delta_prev",
            _delta_tol(got[f"{t}_params"]))
        assert {k[len(f"{t}_m_"):] for k in got
                if k.startswith(f"{t}_m_")} == set(metrics)
        for k, v in metrics.items():
            _close(got[f"{t}_m_{k}"], float(v), k)


# ---------------- (iv) checkpoints ----------------

def test_tp_checkpoint_resumes_in_one_process(job):
    """The (1 x 2) TP run saved after round 1 resumes in this process and
    lands on the ranks' uninterrupted run and the serial run."""
    end, end_meta = _load(job, w.CUT_CELL)
    tr = w.trainer(w.CUT_CELL, sharded=False)
    tr.restore(os.path.join(job, "ckpt_tp"))
    assert tr.start_round == 1
    with tr:
        tr.run()
    _close(tr.flat.numpy(), end["params"], "resumed vs the ranks' run")
    _close(tr.history[-1].train_loss,
           end_meta["history"][-1]["train_loss"], "resumed loss")
    _close(tr.flat.numpy(), port_serial(w.CUT_CELL).flat.numpy(),
           "resumed vs one process")


# ---------------- (v) the TP view, pure functions ----------------

def _lm101m():
    """The ~101M LM of the federated LM example (its non-tiny config)."""
    return get_config(w.ARCH).with_(
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
        d_ff=3072, vocab_size=16384, max_seq_len=512)


def _classes(cfg, model):
    layout = bridge.layout_of(steps.params_spec(cfg))
    shards = ShardLayout.from_sizes(layout, {"clients": 1, "model": model})
    return shards, {"/".join(map(str, p)): c for p, c in
                    zip(layout.paths, tp_classes(shards, cfg))}


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", ["starcoder2-3b", "lm101m"])
def test_tp_view_classes_at_full_size(name, model):
    """Which leaves are viewed in place, which are gathered, and which
    gathered leaves' gradients are summed: at full size on StarCoder2-3B
    (2 KV heads: whole at M = 4, so PARTIAL) and the ~101M LM (4 KV
    heads: split at both M)."""
    cfg = get_config(name) if name != "lm101m" else _lm101m()
    shards, classes = _classes(cfg, model)
    kv_split = cfg.num_kv_heads % model == 0
    want = {r"(^|/)embed$": VIEW, r"lm_head/w$": VIEW,
            r"wq/[wb]$": VIEW, r"wo/w$": VIEW,
            r"(wk|wv)/[wb]$": VIEW if kv_split else PARTIAL,
            r"(up)/[wb]$": VIEW, r"down/w$": VIEW,
            r"(wo|down)/b$": WHOLE, r"norm": WHOLE}
    seen = set()
    for path, cls in classes.items():
        pat = next(p for p in want if re.search(p, path))
        assert cls == want[pat], (path, cls)
        seen.add(pat)
    assert seen == set(want)
    # every rank's view: its VIEW leaves in their local shapes (the
    # Megatron dim cut M-fold, the rest whole) and every other leaf whole
    tree = bridge.layout_of(steps.params_spec(cfg)).unflatten(
        torch.empty(shards.layout.size, device="meta"))
    want_shapes = [tuple(t.shape) for t in bridge.tree_leaves(tree)]
    for m in range(model):
        view = layout_mod.TPView(shards, m, cfg, None)
        assert view.classes == tuple(classes.values())
        for i, shape in enumerate(want_shapes):
            local = view._local.get(i, shape)
            dims = [d for d, (a, b) in enumerate(zip(local, shape))
                    if a != b]
            if view.classes[i] == VIEW:
                assert len(dims) == 1 and local[dims[0]] * model == \
                    shape[dims[0]], (i, local, shape)
            else:
                assert not dims and i not in view._local


def test_tp_view_refuses_an_axis_that_splits_heads():
    """A model axis that does not divide the query heads runs the
    attention whole on every rank: 8 model ranks over StarCoder2 SMOKE's
    4 heads class wq/wk/wv/wo (and their biases) WHOLE — every rank
    computes every head, nothing is summed after wo, a cache holds every
    KV head (sharding/layout.attention_whole; over ranks:
    test_torch_tp_whole_attention.py) — and still split the MLP. The
    route still needs M to divide the MLP width: 3 ranks over its 512
    raise, naming the leaf."""
    cfg = get_config(w.ARCH, smoke=True)
    assert layout_mod.attention_whole(cfg, 8)
    assert not layout_mod.attention_whole(cfg, 4)
    _, classes = _classes(cfg, 8)
    attn = [p for p in classes if re.search(r"(wq|wk|wv|wo)/[wb]$", p)]
    assert attn and all(classes[p] == WHOLE for p in attn)
    assert all(classes[p] == VIEW for p in classes
               if re.search(r"(up|down)/w$", p))
    view = layout_mod.TPView(_classes(cfg, 8)[0], 5, cfg, None)
    assert view.kv_heads() == list(range(cfg.num_kv_heads))
    with pytest.raises(ValueError, match=r"(up|down)/w .*does not split"):
        _classes(cfg, 3)


@pytest.mark.parametrize("arch,item", [
    ("deepseek-v2-236b", "13f"), ("jamba-1.5-large-398b", "13g"),
    ("falcon-mamba-7b", "13g"), ("whisper-base", "13h"),
    ("mla", "13f")])
def test_queued_families_refuse_tensor_parallelism(arch, item):
    """The families ROADMAP items 13f-13h queued — MLA (DeepSeek-V2, and
    with dense MLPs), the Mamba mixer (Jamba, Falcon-Mamba) and the
    encoder-decoder (Whisper) — now refuse no more: their LMLoss trains
    tensor-parallel, their SMOKE tree splits over 2 model ranks, and
    make_train_step over a model group (of one rank here) builds and
    steps as one process (tests/_torch_one_rank.py; M = 2 and 4 against
    the reference in test_torch_tp_families.py). The dense families and
    Kimi-K2 train so too."""
    if arch == "mla":
        cfg = get_config("deepseek-v2-236b", smoke=True).with_(moe=False)
    else:
        cfg = get_config(arch, smoke=True)
    check_tp_route(cfg)
    for dense in ("starcoder2-3b", "phi4-mini-3.8b", "minitron-8b",
                  "command-r-35b", "llava-next-mistral-7b",
                  "kimi-k2-1t-a32b"):
        assert tf.LMLoss(get_config(dense, smoke=True)).tensor_parallel


def test_moe_calls_shard_fn_at_the_references_three_points():
    """shard_fn(tensor, role) is called on the dispatched tokens, the
    experts' hidden and the gated outputs, in the reference's order and
    shapes; an identity shard_fn changes nothing."""
    cfg = get_config("deepseek-v2-236b", smoke=True)
    params = tf.init_lm(cfg, torch.Generator().manual_seed(0),
                        torch.float32)
    p = params["layers"][cfg.first_dense_layers]["mlp"]
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    calls = []

    def shard_fn(z, role):
        calls.append((role, tuple(z.shape)))
        return z
    out, aux = moe_mod.moe_forward(cfg, p, x, groups=2, shard_fn=shard_fn)
    want, want_aux = moe_mod.moe_forward(cfg, p, x, groups=2)
    assert [r for r, _ in calls] == ["dispatched", "expert_hidden",
                                     "combine"]
    e = cfg.num_experts
    assert calls[0][1][:2] == (2, e) and calls[1][1][:2] == (2, e)
    assert calls[2][1][0] == 2 and calls[2][1][2] == cfg.d_model
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(aux, want_aux, rtol=0, atol=0)
