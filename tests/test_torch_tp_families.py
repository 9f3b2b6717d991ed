"""Tensor-parallel local training for the last three families — MLA, the
Mamba mixer and the encoder-decoder — on the CPU.

Two gloo jobs (tests/_torch_tp_families_worker.py, spawned by
launch/distributed.spawn_local: one of two ranks and one of four) run at
once, while this process runs the reference's one-device runs. Held
against the reference, inputs from numpy seeds, weights carried by
``bridge``:

  (i)   launch/steps.make_train_step over a model group of 2 and of 4
        ranks against the reference's one-device step, for DeepSeek-V2
        SMOKE (MLA + MoE, and MLA with dense MLPs), Jamba-1.5 SMOKE (the
        hybrid: at M = 4 its 2 KV heads are whole on every rank, PARTIAL),
        Falcon-Mamba SMOKE and Whisper-base SMOKE's encoder-decoder: both
        losses, every gathered leaf, each rank's shard bit for bit the
        scatter of the gathered vector;
  (ii)  the trainer on the LM task, FedDPC lam = 1, K = 2, on (1 x 2),
        for Jamba-1.5 and DeepSeek-V2 SMOKE, against the reference's
        serial run; the tensor-parallel route, no param_all_gather or
        all_to_all, one feddpc_dots and one feddpc_batched_epilogue a
        rank a round;
  (iii) the leaf classes at full size (sharding/layout.tp_classes) of
        the four configurations at M = 2 and 4, and an axis that splits
        a head or d_inner raising, naming the leaf.
"""
import concurrent.futures
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

import _torch_tp_families_worker as w
from repro.configs.base import get_config as ref_get_config
from repro.core import api as ref_api
from repro.launch import steps as ref_steps
from repro.launch import train as ref_train
from repro.models import encdec as ref_encdec
from repro.models import transformer as ref_tf
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.launch import distributed, steps
from repro_torch.models import attention, encdec, ssm
from repro_torch.models import transformer as tf
from repro_torch.sharding.layout import (PARTIAL, VIEW, WHOLE, ShardLayout,
                                         tp_classes)
from repro_torch.sharding.tensor_parallel import TPContext
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_tp_families_worker.py")
RTOL, ATOL = 1e-5, 1e-6
EPS = float(np.finfo(np.float32).eps)


# ---------------- the two jobs ----------------

@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_families"))
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
        # the reference's runs in threads: XLA compiles without the GIL
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            runs = [pool.submit(ref_train_steps, case)
                    for case in w.STEP_CASES]
            runs += [pool.submit(ref_serial, arch)
                     for arch in w.TRAINER_ARCHS]
            for run in runs:
                run.result()
    finally:
        for t in threads:
            t.join(360)
    assert not any(t.is_alive() for t in threads)
    if failures:
        raise failures[0]
    return out


@functools.lru_cache(maxsize=None)
def ref_train_steps(case):
    """The reference's one-device make_train_step on its init: the
    losses and the params after w.STEPS steps (numpy leaves)."""
    cfg = w.case_config(case, ref_get_config)
    step = jax.jit(ref_steps.make_train_step(cfg, lr=w.STEP_LR,
                                             remat="none"))
    init = (ref_encdec.init_encdec if cfg.is_encoder_decoder
            else ref_tf.init_lm)
    params = init(cfg, jax.random.PRNGKey(w.SEED), jnp.float32)
    batch = jax.tree.map(jnp.asarray, w.step_batch(cfg))
    losses = []
    for _ in range(w.STEPS):
        params, loss = step(params, batch)
        losses.append(float(loss))
    return jax.tree.map(np.asarray, params), losses


@functools.lru_cache(maxsize=None)
def ref_serial(arch):
    params, loss_fn, source, _, _ = ref_train.build_lm_task(w.lm_args(arch))
    with ref_api.FederatedTrainer(
            loss_fn, params, w.CLIENTS, source,
            ref_api.ExecConfig(**w.exec_kw(sharded=False), vectorize=False),
            algo=ref_api.AlgoConfig(name="feddpc", eta_l=w.ETA_L,
                                    eta_g=w.ETA_G)) as tr:
        tr.run()
    return tr


def _load(out, tag, rank=0):
    arrays = dict(np.load(os.path.join(out, f"{tag}_r{rank}.npz")))
    with open(os.path.join(out, f"{tag}_r{rank}.json")) as fh:
        return arrays, json.load(fh)


def _close(got, want, what, tol=None):
    np.testing.assert_allclose(got, want, err_msg=what,
                               **(tol or {"rtol": RTOL, "atol": ATOL}))


def _layout(cfg):
    return bridge.layout_of(steps.params_spec(cfg))


# ---------------- (i) the one-client train step ----------------

@pytest.mark.parametrize("model", [w.PAIR, w.QUAD])
@pytest.mark.parametrize("case", list(w.STEP_CASES))
def test_train_step_over_a_model_group_matches_the_reference(job, case,
                                                             model):
    """w.STEPS SGD steps of make_train_step(remat="full") over M ranks
    against the reference's one-device step: losses within rtol 1e-5,
    every leaf of the gathered params within rtol 1e-5 / atol 1e-6, and
    every rank's shard the scatter of the gathered vector, bit for
    bit."""
    want, want_losses = ref_train_steps(case)
    layout = _layout(w.case_config(case, get_config))
    shards = ShardLayout.from_sizes(layout, {"clients": 1, "model": model})
    got = [dict(np.load(os.path.join(job, f"step_{case}{model}_r{r}.npz")))
           for r in range(model)]
    for g in got:
        _close(g["losses"], want_losses, f"{case}: losses")
        np.testing.assert_array_equal(g["params"], got[0]["params"])
    for m, g in enumerate(got):
        np.testing.assert_array_equal(
            g["shard"], shards.scatter(torch.from_numpy(g["params"]),
                                       m).numpy())
    leaves = layout.unflatten(torch.from_numpy(got[0]["params"]))
    for (path, g), wl in zip(bridge.tree_leaves_with_path(leaves),
                             jax.tree.leaves(want)):
        _close(g.numpy(), wl, f"{case} M={model}: leaf {path}")


# ---------------- (ii) the trainer ----------------

@pytest.mark.parametrize("arch", w.TRAINER_ARCHS)
def test_tp_family_rounds_match_the_reference_serial_run(job, arch):
    """Params, server state and each round's loss and diagnostics of the
    (1 x 2) run against the reference's one-process serial run."""
    arrays, meta = _load(job, arch)
    ref = ref_serial(arch)
    layout = bridge.layout_of(tf.init_lm(get_config(arch, smoke=True),
                                         "meta", torch.float32))
    params = bridge.flat_from_reference(
        jax.tree.map(np.asarray, ref.params), layout).numpy()
    state = {k: v.numpy() for k, v in bridge.server_state_from_reference(
        jax.tree.map(np.asarray, ref.server_state), layout).items()}
    _close(arrays["params"], params, f"{arch}: params")
    # Δ = (w_{t-1} − w)/η_l: an ulp of w, where the model ranks' sums
    # round otherwise than one process's, is ulp/η_l in Δ
    dtol = {"rtol": RTOL,
            "atol": max(ATOL, 4 * EPS * float(np.abs(params).max())
                        / w.ETA_L)}
    assert {k[6:] for k in arrays if k.startswith("state_")} == set(state)
    for k, v in state.items():
        _close(arrays[f"state_{k}"], v, f"{arch}: state {k}", dtol)
    assert len(meta["history"]) == len(ref.history) == w.ROUNDS
    for got, want in zip(meta["history"], ref.history):
        _close(got["train_loss"], want.train_loss, f"{arch}: loss")
        assert got["comm_bytes_up"] == want.comm_bytes_up
        assert set(got["diagnostics"]) == set(want.diagnostics)


@pytest.mark.parametrize("arch", w.TRAINER_ARCHS)
def test_tp_family_ranks_take_the_route_and_hold_their_shards(job, arch):
    """Both ranks train every row of the slice on their shards (the
    tensor-parallel route), gather the same params and state bit for bit
    and hold at rest their scatter; the rounds issue the model group's
    tp_leaf_gather and tp_all_reduce and no param_all_gather or
    all_to_all, the same collectives in the same order on both ranks,
    and one feddpc_dots and one feddpc_batched_epilogue a round."""
    shards = ShardLayout.from_sizes(
        bridge.layout_of(tf.init_lm(get_config(arch, smoke=True), "meta",
                                    torch.float32)),
        {"clients": 1, "model": w.PAIR})
    arrays0, meta0 = _load(job, arch)
    for rank in range(w.PAIR):
        arrays, meta = _load(job, arch, rank)
        info = meta["shard"]
        assert info["route"] == "tensor_parallel"
        assert info["train_rows"] == info["slice_rows"] == [0, w.K]
        assert info["N_m"] < info["N"]
        for k in arrays0:
            if not k.startswith("shard_"):
                np.testing.assert_array_equal(arrays[k], arrays0[k],
                                              err_msg=(arch, rank, k))
        np.testing.assert_array_equal(
            arrays["shard_params"],
            shards.scatter(torch.from_numpy(arrays["params"]),
                           rank).numpy())
        names = {n for r in meta["collectives"] for n in r}
        assert not names & {"param_all_gather", "all_to_all"}, names
        assert {"tp_leaf_gather", "tp_all_reduce"} <= names
        assert meta["collectives"] == meta0["collectives"]
        assert meta["calls"] == {"feddpc_dots": w.ROUNDS,
                                 "feddpc_batched_epilogue": w.ROUNDS}


# ---------------- (iii) the leaf classes, pure functions ----------------

FULL = ("deepseek-v2-236b", "jamba-1.5-large-398b", "falcon-mamba-7b",
        "whisper-base")


def _classes(cfg, model):
    layout = _layout(cfg)
    shards = ShardLayout.from_sizes(layout, {"clients": 1, "model": model})
    return {"/".join(map(str, p)): c for p, c in
            zip(layout.paths, tp_classes(shards, cfg))}


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("arch", FULL)
def test_tp_classes_of_the_families_at_full_size(arch, model):
    """At full size (meta trees): Mamba's in_proj PARTIAL and its channel
    leaves VIEW, MLA's q_down/kv_down WHOLE and q_up/k_up/v_up/wo VIEW,
    each split on whole heads of its own width, Whisper's embed and
    lm_head WHOLE (51,865 rows over neither 2 nor 4), the norms WHOLE."""
    cfg = get_config(arch)
    classes = _classes(cfg, model)
    want = {r"in_proj/w$": PARTIAL,
            r"(conv_w|conv_b|d_skip|a_log|dt_proj/[wb]|x_proj/w|"
            r"out_proj/w)$": VIEW,
            r"(q_down|kv_down)/w$": WHOLE,
            r"(q_up|k_up|v_up|wq|wo)/w$": VIEW,
            r"(wk|wv)/[wb]$": VIEW if cfg.num_kv_heads % model == 0
            else PARTIAL,
            r"norm": WHOLE,
            r"(^|/)(embed|lm_head/w)$": VIEW if cfg.vocab_size % model == 0
            else WHOLE}
    seen = set()
    for path, cls in classes.items():
        pat = next((p for p in want if re.search(p, path)), None)
        if pat is not None:
            assert cls == want[pat], (path, cls)
            seen.add(pat)
    kinds = {kind for kind, _ in tf.layer_specs(cfg)}
    assert (r"in_proj/w$" in seen) == ("ssm" in kinds)
    assert (r"(q_up|k_up|v_up|wq|wo)/w$" in seen) == ("attn" in kinds
                                                       or cfg.encoder_layers)
    if arch == "whisper-base":
        assert classes["embed"] == classes["lm_head/w"] == WHOLE
    # each VIEW leaf of the attention on whole heads of its own width
    widths = {"q_up": cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
              "k_up": cfg.qk_nope_head_dim, "v_up": cfg.v_head_dim,
              "wq": cfg.resolved_head_dim,
              "wo": (cfg.v_head_dim if cfg.attention == "mla"
                     else cfg.resolved_head_dim)}
    layout = _layout(cfg)
    for path, shape in zip(layout.paths, layout.shapes):
        name = "/".join(map(str, path))
        leaf = next((k for k in widths if name.endswith(f"{k}/w")), None)
        if leaf is not None:
            dim = shape[-2] if leaf == "wo" else shape[-1]
            assert (dim // model) % widths[leaf] == 0, name


@pytest.mark.parametrize("arch,smoke,model,leaf", [
    ("deepseek-v2-236b", False, 3, r"(q_up|k_up|v_up|wo)/w"),
    ("deepseek-v2-236b", True, 8, r"(q_up|k_up|v_up|wo)/w"),
    ("falcon-mamba-7b", False, 3, r"(conv_w|conv_b|dt_proj|a_log|d_skip|"
                                  r"x_proj|out_proj)"),
    ("jamba-1.5-large-398b", False, 3, r"(conv_w|conv_b|dt_proj|a_log|"
                                       r"d_skip|x_proj|out_proj|wq|wo|"
                                       r"gate|up|down)")])
def test_an_axis_that_splits_a_head_or_d_inner_raises(arch, smoke, model,
                                                      leaf):
    """A model axis that does not cut the attention on whole heads of
    their own width (M = 3 over DeepSeek-V2's 128 heads; M = 8 over its
    SMOKE config's 4) or that does not divide d_inner (M = 3 over
    Falcon-Mamba's 8,192 and Jamba's 16,384): tp_classes raises, naming
    the leaf, and no family quietly takes the row split."""
    with pytest.raises(ValueError, match=leaf) as e:
        _classes(get_config(arch, smoke=smoke), model)
    assert "does not split on its Megatron dim" in str(e.value)


def test_tp_serving_of_the_families_cites_item_13i():
    """Item 13i, ported: the tensor-parallel MLA, Mamba mixer and
    encoder-decoder serve with a cache or state on the model axis (over
    ranks: tests/test_torch_tp_serve.py). On a model group of one rank
    (its sum the identity), a prefill and a decode step with ``tp`` give
    one process's outputs and states bit for bit."""
    one = TPContext(group=None, rank=0, size=1,
                    timer=lambda name, x, run: None)
    rng = np.random.RandomState(3)
    for arch in ("deepseek-v2-236b", "falcon-mamba-7b", "whisper-base"):
        cfg = get_config(arch, smoke=True)
        toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 6)))
        if cfg.is_encoder_decoder:
            params = encdec.init_encdec(cfg, torch.Generator().manual_seed(0),
                                        torch.float32)
            enc = torch.from_numpy(rng.randn(2, cfg.encoder_seq_len,
                                             cfg.d_model).astype(np.float32))

            def run(tp):
                states = encdec.init_decoder_states(cfg, 2, 7, torch.float32)
                out, states = encdec.decode(cfg, params, toks, enc,
                                            states=states, tp=tp)
                step, states = encdec.decode(
                    cfg, params, toks[:, :1], enc, states=states, tp=tp,
                    positions=torch.full((2, 1), 6, dtype=torch.int32))
                return [out, step] + [c[k] for c in states for k in "kv"]
        else:
            params = tf.init_lm(cfg, torch.Generator().manual_seed(0),
                                torch.float32)
            mixers = [lp["mixer"] for lp in params["layers"]]
            h = torch.from_numpy(rng.randn(2, 6, cfg.d_model).astype(
                np.float32))
            pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6)
            fwd = (attention.mla_forward if cfg.attention == "mla"
                   and cfg.arch_type != "ssm" else None)

            def run(tp):
                outs = []
                for p, st in zip(mixers, tf.init_states(cfg, 2, 7,
                                                        torch.float32)):
                    if fwd is None:
                        o, st = ssm.mamba_forward(cfg, p, h, state=st, tp=tp)
                        o2, st = ssm.mamba_forward(cfg, p, h[:, :1],
                                                   state=st, tp=tp)
                    else:
                        o, st = fwd(cfg, p, h, pos, cache=st, tp=tp)
                        o2, st = fwd(cfg, p, h[:, :1], pos[:, :1] + 6,
                                     cache=st, tp=tp)
                    outs += [o, o2] + [v for v in st.values()
                                       if torch.is_tensor(v)]
                return outs
        with torch.inference_mode():
            for got, want in zip(run(one), run(None)):
                assert torch.equal(got, want), arch
