"""Tensor-parallel serving (launch/steps.make_prefill_step and
make_decode_step with ``model_group=``, and with ``moe_impl="ep"`` on a
(data, model) mesh) on the CPU, held against the reference.

Two gloo jobs (tests/_torch_tp_serve_worker.py, spawned by
launch/distributed.spawn_local: one of two ranks and one of four) run at
once, while this process runs the reference's one-device steps and a
subprocess runs the reference's expert-parallel steps on a forced
4-device CPU mesh (as tests/test_moe_ep.py). Every family at its SMOKE
size — dense StarCoder2, MLA + MoE DeepSeek-V2, the SSM Falcon-Mamba, the
hybrid Jamba, the VLM LLaVA-NeXT and the encoder-decoder Whisper — at M
= 2 and 4, from the reference's init carried by ``bridge`` and the same
numpy prompts: a prefill, then 3 teacher-forced decode steps. Held:

  (i)   the whole last-position logits of every step, on every rank,
        and the states gathered from the ranks after the prefill and
        after the last step, against the reference's (rtol 1e-5, atol
        ATOL; ``pos`` and ``idx`` exactly);
  (ii)  DeepSeek-V2 with ``moe_impl="ep"`` on (2 x 2) at capacity
        factor 8 against the reference's ``moe_impl="ep"`` steps;
  (iii) what a rank's step issues: no parameter gather in a decode
        step — only the model group's sums and the logits' all-gather
        (and the expert-parallel exchange) — and a rank's params cut
        from its shard equal to those cut from whole leaves; a rank's
        cache bytes;
  (iv)  what still refuses.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_serve_worker as w
from repro.configs import shapes as ref_shapes
from repro.configs.base import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models import encdec as ref_encdec
from repro.models import transformer as ref_tf
from repro_torch import bridge
from repro_torch.configs import shapes
from repro_torch.configs.base import get_config
from repro_torch.launch import distributed, steps
from repro_torch.models import transformer as tf
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_tp_serve_worker.py")
# f32 products summed in another order over the ranks (the row-parallel
# sums, the vocab slices): logits and states within rtol 1e-5 and this
RTOL, ATOL = 1e-5, 2e-5


# ---------------- the two jobs, the reference's EP run ----------------

EP_SUBPROC = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "tests")
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import shapes
    from repro.configs.base import get_config
    from repro.launch import steps
    from repro.launch.mesh import _mesh_kwargs
    from repro.models import transformer as tf
    import _torch_tp_serve_worker as w
    cfg = w.case_config(w.EP_CASE, get_config, ep=True)
    mesh = jax.make_mesh((2, 2), ("data", "model"), **_mesh_kwargs(2))
    params = tf.init_lm(cfg, jax.random.PRNGKey(w.SEED), jnp.float32)
    data = w.inputs(cfg)
    kw = dict(moe_impl="ep", moe_mesh=mesh)
    with mesh:
        prefill = jax.jit(steps.make_prefill_step(
            cfg, shapes.SHAPES["prefill_32k"], **kw))
        decode = jax.jit(steps.make_decode_step(
            cfg, shapes.SHAPES["decode_32k"], **kw))
        states = tf.init_states(cfg, w.B, w.capacity(cfg), jnp.float32)
        states, logits = prefill(params, states, data["tokens"])
        out = {"logits_0": np.asarray(logits)}
        for i in range(w.EXTRA):
            pos = np.full((w.B, 1), w.PROMPT + i, np.int32)
            states, logits = decode(params, states, data["forced"][i], pos)
            out[f"logits_{i + 1}"] = np.asarray(logits)
    out.update({"states/" + jax.tree_util.keystr(p): np.asarray(x) for p, x
                in jax.tree_util.tree_leaves_with_path(states)})
    np.savez(sys.argv[1], **out)
    print("EP-SERVE-OK")
""")


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_serve"))
    env = {"PYTHONPATH": os.path.join(ROOT, "src")}
    failures = []

    def spawn(n):
        try:
            distributed.spawn_local([sys.executable, WORKER, "--out", out],
                                    n, timeout_s=300, env=env)
        except RuntimeError as e:
            failures.append(e)

    def ep_reference():
        penv = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        proc = subprocess.run(
            [sys.executable, "-c", EP_SUBPROC,
             os.path.join(out, "ep_reference.npz")], env=penv, cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        if "EP-SERVE-OK" not in proc.stdout:
            failures.append(RuntimeError(proc.stdout + proc.stderr))
    threads = [threading.Thread(target=spawn, args=(n,))
               for n in (w.PAIR, w.QUAD)]
    threads.append(threading.Thread(target=ep_reference))
    for t in threads:
        t.start()
    try:
        for case in w.CASES:
            ref_serve(case)
    finally:
        for t in threads:
            t.join(360)
    assert not any(t.is_alive() for t in threads)
    if failures:
        raise failures[0]
    return out


@functools.lru_cache(maxsize=None)
def ref_serve(case):
    """The reference's one-device make_prefill_step and make_decode_step
    on its init and the worker's inputs: {"logits_i", "<stage>/<layer>/
    <key>"} as the worker dumps them (its states through ``bridge``)."""
    cfg = w.case_config(case, ref_get_config)
    pcfg = w.case_config(case, get_config)
    data = w.inputs(cfg)
    prefill = jax.jit(ref_steps.make_prefill_step(
        cfg, ref_shapes.SHAPES["prefill_32k"]))
    decode = jax.jit(ref_steps.make_decode_step(
        cfg, ref_shapes.SHAPES["decode_32k"]))
    key = jax.random.PRNGKey(w.SEED)
    cap = w.capacity(cfg)
    if cfg.is_encoder_decoder:
        params = ref_encdec.init_encdec(cfg, key, jnp.float32)
        states = {"decoder": ref_encdec.init_decoder_states(cfg, w.B, cap,
                                                            jnp.float32)}
        states, logits = prefill(params, states, data["frames"],
                                 data["tokens"])
    else:
        params = ref_tf.init_lm(cfg, key, jnp.float32)
        states = ref_tf.init_states(cfg, w.B, cap, jnp.float32)
        states, logits = prefill(params, states, data["tokens"],
                                 *([data["patch_embeds"]]
                                   if "patch_embeds" in data else []))
    out = {"logits_0": np.asarray(logits),
           **_port_states(states, pcfg, "prefill")}
    for i in range(w.EXTRA):
        pos = np.full((w.B, 1), w.prefix(cfg) + w.PROMPT + i, np.int32)
        states, logits = decode(params, states, data["forced"][i], pos)
        out[f"logits_{i + 1}"] = np.asarray(logits)
    out.update(_port_states(states, pcfg, "last"))
    return out


def _port_states(states, cfg, stage):
    np_states = jax.tree.map(np.asarray, states)
    if cfg.is_encoder_decoder:
        port = {"decoder": bridge.encdec_states_from_reference(
            np_states["decoder"], cfg),
            "enc_out": torch.from_numpy(np_states["enc_out"])}
    else:
        port = bridge.lm_states_from_reference(np_states, cfg)
    return w.flat_states(port, stage)


def _load(out, tag, rank):
    with open(os.path.join(out, f"{tag}_r{rank}.json")) as fh:
        return dict(np.load(os.path.join(out, f"{tag}_r{rank}.npz"))), \
            json.load(fh)


def _check(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, v in want.items():
        if k.endswith(("/pos", "/idx")):
            np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {k}")


# ---------------- (i) every family at M = 2 and 4 ----------------

@pytest.mark.parametrize("model", [w.PAIR, w.QUAD])
@pytest.mark.parametrize("case", list(w.CASES))
def test_tp_serving_matches_the_reference(job, case, model):
    """A prefill and 3 decode steps over M ranks against the reference's
    one-device steps: every rank's whole logits of each step, and the
    states the ranks gather after the prefill and after the last step
    (each rank's caches its KV heads, MLA's latent whole, each SSM state
    its channels), within rtol 1e-5 / atol ATOL."""
    want = ref_serve(case)
    for rank in range(model):
        got, _ = _load(job, f"{case}{model}", rank)
        _check(got, want, f"{case} M={model} rank {rank}")


# ---------------- (ii) the expert-parallel form ----------------

def test_ep_serving_matches_the_reference_ep_steps(job):
    """DeepSeek-V2 SMOKE with moe_impl="ep" on a (2 x 2) make_debug_mesh
    at capacity factor 8 — each data rank prefills and decodes its 2 rows
    of the batch in its own caches, the tokens to their experts' owners by
    the all-to-all in every step — against the reference's
    moe_impl="ep" steps on a forced 4-device mesh: logits and the
    gathered states."""
    ref = dict(np.load(os.path.join(job, "ep_reference.npz")))
    cfg = w.case_config(w.EP_CASE, get_config, ep=True)
    want = {k: v for k, v in ref.items() if k.startswith("logits_")}
    # the reference's final states: its tree by key path -> the port's
    leaves = [(k[len("states/"):], v) for k, v in ref.items()
              if k.startswith("states/")]
    tree = ref_tf.init_states(ref_get_config(w.CASES[w.EP_CASE],
                                             smoke=True), w.B,
                              w.capacity(cfg), jnp.float32)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(tree)]
    by_path = dict(leaves)
    final = jax.tree.unflatten(jax.tree.structure(tree),
                               [by_path[p] for p in paths])
    want.update(_port_states(final, cfg, "last"))
    for rank in range(w.QUAD):
        got, meta = _load(job, "ep", rank)
        got = {k: v for k, v in got.items() if k in want}
        _check(got, want, f"ep rank {rank}")
        names = {n for step in meta["decode_collectives"] for n in step}
        assert "ep_all_to_all" in names, names


# ---------------- (iii) what a step issues ----------------

def _expected_sums(cfg):
    """A decode step's model-group sums: one after each layer's mixer and
    one after its MLP (x_proj's and out_proj's for a Mamba layer), and
    the vocab-parallel embedding's lookup."""
    per_layer = 2
    split_embed = cfg.vocab_size % w.PAIR == 0
    return per_layer * cfg.num_layers + split_embed


@pytest.mark.parametrize("model", [w.PAIR, w.QUAD])
@pytest.mark.parametrize("case", list(w.CASES))
def test_a_decode_step_gathers_no_parameter(job, case, model):
    """Each decode step on each rank issues the model group's sums and the
    logits' one all-gather, the same list on every rank, and no
    parameter gather (tp_leaf_gather) or state gather: the WHOLE and
    PARTIAL leaves were cut once. A rank's params cut from its shard
    (gathered a leaf at a time) equal those cut from whole leaves."""
    cfg = w.case_config(case, get_config)
    first = None
    for rank in range(model):
        _, meta = _load(job, f"{case}{model}", rank)
        assert meta["params_from_shard_equal"]
        for step in meta["decode_collectives"]:
            assert set(step) <= {"tp_all_reduce", "tp_all_gather"}, step
            assert step.count("tp_all_gather") == 1
            if case in ("starcoder2", "falcon_mamba", "llava"):
                assert step.count("tp_all_reduce") == _expected_sums(cfg)
        first = first or meta["decode_collectives"]
        assert meta["decode_collectives"] == first


@pytest.mark.parametrize("case", ["starcoder2", "falcon_mamba", "deepseek"])
def test_a_rank_holds_its_share_of_the_caches(job, case):
    """At M = 4 a rank's cache bytes: StarCoder2 SMOKE's K/V one of its 2
    KV heads (M does not divide them: the head its query head reads),
    Falcon-Mamba's states a quarter of d_inner, DeepSeek-V2's latent
    cache whole on every rank."""
    cfg = w.case_config(case, get_config)
    whole = tf.init_states(cfg, w.B, w.capacity(cfg), torch.float32)
    nbytes = lambda t: t.numel() * t.element_size()
    _, meta = _load(job, f"{case}{w.QUAD}", 0)
    if case == "starcoder2":
        want = sum(nbytes(c["k"]) // 2 + nbytes(c["v"]) // 2
                   + nbytes(c["pos"]) for c in whole)
    elif case == "falcon_mamba":
        want = sum(nbytes(st["conv"]) // 4 + nbytes(st["h"]) // 4
                   for st in whole)
    else:
        want = sum(nbytes(x) for c in whole for x in c.values()
                   if torch.is_tensor(x))
    assert meta["cache_bytes"] == want


# ---------------- (iv) what still refuses ----------------

def test_ep_serving_without_a_mesh_raises():
    """moe_impl="ep" serves over a (data, model) mesh: without moe_mesh
    both steps raise ValueError; with a model group as well they raise
    (the mesh gives the model axis)."""
    cfg = get_config("deepseek-v2-236b", smoke=True)
    shape = shapes.SHAPES["prefill_32k"]
    for make in (steps.make_prefill_step, steps.make_decode_step):
        with pytest.raises(ValueError, match="moe_mesh"):
            make(cfg, shape, moe_impl="ep")
        with pytest.raises(ValueError, match="model_group"):
            make(cfg, shape, moe_impl="ep", moe_mesh=object(),
                 model_group=object())
