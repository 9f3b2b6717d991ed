"""Attention whole on every rank where the model axis does not divide
the query heads (sharding/layout.attention_whole): M = 3 over SMOKE
configs with 4 heads — StarCoder2's decoder (4 on 2 KV heads) and
Whisper-base's encoder-decoder (self- and cross-attention) — their MLP
width 384 so that it still splits.

One gloo job of 3 ranks (tests/_torch_whole_attention_worker.py, spawned
by launch/distributed.spawn_local) runs, over the job as one model
group: make_train_step's tensor-parallel step (2 SGD steps on the
reference's init) and a prefill and 3 decode steps of make_prefill_step
/ make_decode_step. While it runs, this process runs the reference's
one-device steps on the same configs, inits and numpy inputs, and each
rank is held against them (weights and states carried by ``bridge``)
within the tensor-parallel tests' tolerances: every rank computes every
head, so nothing is summed after ``wo`` and each cache holds every KV
head; the MLP is Megatron's. The same job also runs the (data, model)
form of the step (``data_group=``: 3 data ranks, 2 of 6 rows each, the
gradients averaged over them), held against the reference's step on all
6 rows.
"""
import functools
import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_families_worker as fam
import _torch_tp_serve_worker as ts
import _torch_whole_attention_worker as w
from repro.configs import shapes as ref_shapes
from repro.configs.base import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models import encdec as ref_encdec
from repro.models import transformer as ref_tf
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.launch import distributed, steps
from repro_torch.sharding.layout import (VIEW, WHOLE, ShardLayout,
                                         attention_whole, tp_classes)
from repro_torch.sharding.rules import path_str
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_whole_attention_worker.py")
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 1e-6        # test_torch_tp_families.py's
SERVE_RTOL, SERVE_ATOL = 1e-5, 2e-5        # test_torch_tp_serve.py's


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("whole_attention"))
    failures = []

    def spawn():
        try:
            distributed.spawn_local(
                [sys.executable, WORKER, "--out", out], w.RANKS,
                timeout_s=300, env={"PYTHONPATH": os.path.join(ROOT, "src"),
                                    "CUDA_VISIBLE_DEVICES": ""})
        except RuntimeError as e:
            failures.append(e)
    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        for case in w.CASES:
            ref_train(case)
            ref_serve(case)
        ref_data_parallel()
    finally:
        thread.join(360)
    assert not thread.is_alive()
    if failures:
        raise failures[0]
    return out


def _ref_init(cfg):
    init = (ref_encdec.init_encdec if cfg.is_encoder_decoder
            else ref_tf.init_lm)
    return init(cfg, jax.random.PRNGKey(w.SEED), jnp.float32)


def _ref_steps(cfg, batch):
    """The reference's one-device make_train_step, w.STEPS steps on its
    init -> (numpy params tree, losses)."""
    step = jax.jit(ref_steps.make_train_step(cfg, lr=w.STEP_LR,
                                             remat="none"))
    params = _ref_init(cfg)
    batch = jax.tree.map(jnp.asarray, batch)
    losses = []
    for _ in range(w.STEPS):
        params, loss = step(params, batch)
        losses.append(float(loss))
    return jax.tree.map(np.asarray, params), losses


@functools.lru_cache(maxsize=None)
def ref_train(case):
    cfg = w.case_config(case, ref_get_config)
    return _ref_steps(cfg, fam.step_batch(cfg))


@functools.lru_cache(maxsize=None)
def ref_data_parallel():
    """The reference's step on all w.DP_ROWS rows, and its loss on each
    data rank's rows at the init."""
    cfg = w.case_config("starcoder2", ref_get_config)
    batch = w.dp_batch(cfg)
    per = w.DP_ROWS // w.RANKS
    params = _ref_init(cfg)
    first = [float(ref_tf.loss_fn(cfg, params,
                                  {k: jnp.asarray(v[r * per:(r + 1) * per])
                                   for k, v in batch.items()}))
             for r in range(w.RANKS)]
    return _ref_steps(cfg, batch), first


@functools.lru_cache(maxsize=None)
def ref_serve(case):
    """The reference's one-device make_prefill_step and make_decode_step
    on its init and the tp_serve worker's inputs: {"logits_i",
    "<stage>/<layer>/<key>"} as the worker dumps them (its states
    through ``bridge``)."""
    cfg = w.case_config(case, ref_get_config)
    pcfg = w.case_config(case, get_config)
    data = ts.inputs(cfg)
    prefill = jax.jit(ref_steps.make_prefill_step(
        cfg, ref_shapes.SHAPES["prefill_32k"]))
    decode = jax.jit(ref_steps.make_decode_step(
        cfg, ref_shapes.SHAPES["decode_32k"]))
    params = _ref_init(cfg)
    cap = ts.capacity(cfg)
    if cfg.is_encoder_decoder:
        states = {"decoder": ref_encdec.init_decoder_states(cfg, ts.B, cap,
                                                            jnp.float32)}
        states, logits = prefill(params, states, data["frames"],
                                 data["tokens"])
    else:
        states = ref_tf.init_states(cfg, ts.B, cap, jnp.float32)
        states, logits = prefill(params, states, data["tokens"])
    out = {"logits_0": np.asarray(logits),
           **_port_states(states, pcfg, "prefill")}
    for i in range(ts.EXTRA):
        pos = np.full((ts.B, 1), ts.prefix(cfg) + ts.PROMPT + i, np.int32)
        states, logits = decode(params, states, data["forced"][i], pos)
        out[f"logits_{i + 1}"] = np.asarray(logits)
    out.update(_port_states(states, pcfg, "last"))
    return out


def _port_states(states, cfg, stage):
    np_states = jax.tree.map(np.asarray, states)
    if cfg.is_encoder_decoder:
        port = {"decoder": bridge.encdec_states_from_reference(
            np_states["decoder"], cfg),
            "enc_out": torch.from_numpy(np.array(np_states["enc_out"]))}
    else:
        port = bridge.lm_states_from_reference(np_states, cfg)
    return ts.flat_states(port, stage)


def _close_params(got_flat, want, cfg, what):
    """Every leaf of a port flat vector against the reference's tree."""
    layout = bridge.layout_of(steps.params_spec(cfg))
    leaves = layout.unflatten(torch.from_numpy(got_flat))
    for (path, g), wl in zip(bridge.tree_leaves_with_path(leaves),
                             jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), wl, rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL,
                                   err_msg=f"{what}: leaf {path}")


@pytest.mark.parametrize("case", list(w.CASES))
def test_the_attention_is_whole_and_the_mlp_split(job, case):
    """At M = 3 over 4 heads every attention leaf (wq, wk, wv, wo and
    their biases) is WHOLE on every rank, the MLP's weights VIEW."""
    cfg = w.case_config(case, get_config)
    assert attention_whole(cfg, w.RANKS)
    layout = bridge.layout_of(steps.params_spec(cfg))
    shards = ShardLayout.from_sizes(layout, {"clients": 1,
                                             "model": w.RANKS})
    classes = tp_classes(shards, cfg)
    for rank in range(w.RANKS):
        with open(os.path.join(job, f"meta_r{rank}.json")) as fh:
            meta = json.load(fh)[case]
        assert meta["classes"] == classes
        assert meta["kv_heads"] == [cfg.num_kv_heads]
    attn = mlp = 0
    for path, cls in zip(layout.paths, classes):
        name = path_str(path)
        if any(f"{k}/" in name for k in ("wq", "wk", "wv", "wo")):
            assert cls == WHOLE, name
            attn += 1
        elif name.endswith(("up/w", "down/w", "gate/w")):
            assert cls == VIEW, name
            mlp += 1
    assert attn and mlp


@pytest.mark.parametrize("case", list(w.CASES))
def test_train_step_matches_one_process(job, case):
    """w.STEPS steps over the 3 ranks against the reference's one-device
    step: the losses, and every leaf of each rank's gathered params."""
    want_params, want_losses = ref_train(case)
    cfg = w.case_config(case, get_config)
    for rank in range(w.RANKS):
        got = np.load(os.path.join(job, f"train_{case}_r{rank}.npz"))
        np.testing.assert_allclose(got["losses"], want_losses,
                                   rtol=TRAIN_RTOL, err_msg="losses")
        _close_params(got["params"], want_params, cfg,
                      f"{case} rank {rank}")


@pytest.mark.parametrize("case", list(w.CASES))
def test_serving_matches_one_process(job, case):
    """A prefill and 3 decode steps over the 3 ranks against the
    reference's one-device steps: every rank's logits of each step and
    the states gathered after the prefill and after the last step
    (``pos`` and ``idx`` exactly)."""
    want = ref_serve(case)
    for rank in range(w.RANKS):
        got = np.load(os.path.join(job, f"serve_{case}_r{rank}.npz"))
        assert set(got.files) == set(want)
        for key, value in want.items():
            if key.endswith(("/pos", "/idx")):
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            else:
                np.testing.assert_allclose(got[key], value,
                                           rtol=SERVE_RTOL,
                                           atol=SERVE_ATOL, err_msg=key)


def test_the_data_parallel_form_matches_one_process_on_the_batch(job):
    """make_train_step(model_group=, data_group=): each of 3 data ranks
    steps on its 2 of 6 rows, every gradient averaged over them (every
    label valid, so that is the whole batch's mean gradient); its params
    after 2 steps are the reference's one-device step's on all 6 rows,
    and its first loss is the reference's loss on its own 2 rows."""
    (want, _), first = ref_data_parallel()
    cfg = w.case_config("starcoder2", get_config)
    for rank in range(w.RANKS):
        got = np.load(os.path.join(job, f"dp_r{rank}.npz"))
        np.testing.assert_allclose(got["losses"][0], first[rank],
                                   rtol=TRAIN_RTOL, err_msg=f"rank {rank}")
        _close_params(got["params"], want, cfg, f"rank {rank}")
