"""The MoE layer, MLA and the MoE / hybrid decoder stacks of the port
against the reference, on the CPU, from the same numpy inputs and the
reference's params carried across by the bridge: routing and slot tables
bit for bit, ``moe_forward`` at 1 and 4 groups with ample and tight
capacity, MLA's materialised (prefill) and absorbed (decode) paths, the
SMOKE configs of DeepSeek-V2 (MLA + MoE), Jamba (Mamba + attention +
MoE) and Kimi-K2 (GQA + MoE) through prefill and teacher-forced decode,
``loss_fn`` with the aux term and its gradients, and the steps' specs
and MoE arguments.

Tolerances: f32 products summed in other orders — layer outputs within
1e-5, the decoders' logits and caches within 1e-4 (two layers), the aux
term within 1e-6, gradients within 1e-5."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import shapes as ref_shapes
from repro.configs.base import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models import attention as ref_attn
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro_torch import bridge
from repro_torch.configs import shapes
from repro_torch.configs.base import get_config
from repro_torch.core import jax_prng
from repro_torch.launch import steps
from repro_torch.models import attention, moe
from repro_torch.models import transformer as tf
from _torch_threads import one_intra_op_thread  # noqa: F401

DEEPSEEK, JAMBA, KIMI = ("deepseek-v2-236b", "jamba-1.5-large-398b",
                         "kimi-k2-1t-a32b")
MOE_ARCHS = (DEEPSEEK, JAMBA, KIMI)
LAYER_TOL, LM_TOL, AUX_TOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_get_config(arch, smoke=True)
    return _np(jax.jit(lambda k: ref_tf.init_lm(cfg, k, jnp.float32))(
        jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _ref_moe_params(arch):
    cfg = ref_get_config(arch, smoke=True)
    return _np(ref_moe.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32))


# ---- routing ----

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_and_slot_tables_match_the_reference(arch):
    """Softmax top-k with renormalised gates, the load-balance aux and the
    slot tables: expert ids and both tables bit for bit, gates within
    1e-6, at an ample and a tight capacity (slots dropped)."""
    cfg = get_config(arch, smoke=True)
    logits = np.random.default_rng(1).standard_normal(
        (3, 40, cfg.num_experts)).astype(np.float32)
    w_gates, w_idx, w_aux = ref_moe._route(cfg, jnp.asarray(logits))
    gates, idx, aux = moe._route(cfg, _t(logits))
    assert np.array_equal(idx.numpy(), np.asarray(w_idx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(w_gates), rtol=0,
                               atol=1e-6)
    assert abs(float(aux) - float(w_aux)) <= AUX_TOL
    for cap in (moe.capacity_per_group(cfg, 40), 4):
        want = ref_moe._slot_tables(cfg, w_idx, w_gates, cap)
        got = moe._slot_tables(cfg, _t(np.asarray(w_idx)),
                               _t(np.asarray(w_gates)), cap)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), cap
    kept = (got[0].numpy() < 40).sum()
    assert kept == 3 * cfg.num_experts * 4 < 3 * 40 * cfg.top_k   # drops


def test_route_ties_take_the_lower_expert():
    """Equal probabilities: top-k picks the lower expert index, as
    jax.lax.top_k does."""
    cfg = get_config(KIMI, smoke=True)
    logits = np.zeros((1, 3, cfg.num_experts), np.float32)
    logits[0, 1, 2:] = 1.0
    _, idx, _ = moe._route(cfg, _t(logits))
    _, w_idx, _ = ref_moe._route(cfg, jnp.asarray(logits))
    assert np.array_equal(idx.numpy(), np.asarray(w_idx))
    assert idx[0, 0].tolist() == [0, 1] and idx[0, 1].tolist() == [2, 3]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_per_group_matches_the_reference(arch):
    cfg = get_config(arch)
    for tokens in (1, 8, 100, 1000, 8192):
        assert moe.capacity_per_group(cfg, tokens) == \
            ref_moe.capacity_per_group(cfg, tokens)


# ---- the layer ----

@pytest.mark.parametrize("arch", [DEEPSEEK, JAMBA])
def test_init_moe_draws_the_references_params(arch):
    cfg = get_config(arch, smoke=True)
    got = moe.init_moe(jax_prng.PRNGKey(3), cfg, torch.float32)
    want = _ref_moe_params(arch)
    got_l = list(bridge.tree_leaves_with_path(got))
    want_l = jax.tree_util.tree_leaves_with_path(want)
    assert len(got_l) == len(want_l)
    for (_, g), (_, w) in zip(got_l, want_l):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.3])
@pytest.mark.parametrize("groups", [1, 4])
def test_moe_forward_matches_the_reference(groups, capacity_factor):
    """DeepSeek-V2 SMOKE's layer (a shared expert): output within 1e-5
    and the scaled aux within 1e-6, at 1 and 4 groups and at the default
    capacity factor and a tight one that drops assignments."""
    arch = DEEPSEEK
    cfg = get_config(arch, smoke=True).with_(capacity_factor=capacity_factor)
    np_params = _ref_moe_params(arch)
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    want, w_aux = jax.jit(functools.partial(
        ref_moe.moe_forward, cfg, groups=groups))(np_params, jnp.asarray(x))
    got, aux = moe.moe_forward(cfg, bridge.to_torch(np_params), _t(x),
                               groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LAYER_TOL)
    assert abs(float(aux) - float(w_aux)) <= AUX_TOL


# ---- MLA ----

def _mla_setup():
    cfg = get_config(DEEPSEEK, smoke=True)
    p = _np(ref_attn.init_mla(jax.random.PRNGKey(5), cfg, jnp.float32))
    rng = np.random.default_rng(3)
    return cfg, p, rng


def test_mla_materialised_and_absorbed_paths_match_the_reference():
    """A full-sequence forward (no cache), a prefill of 8 tokens into a
    12-slot cache and 3 absorbed decode steps: outputs within 1e-5, the
    latent caches within 1e-5, positions and idx exact."""
    cfg, p, rng = _mla_setup()
    tp = bridge.to_torch(p)
    b, s, cap = 2, 8, 12
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    ref_mla = jax.jit(functools.partial(ref_attn.mla_forward, cfg))
    want, _ = ref_mla(p, jnp.asarray(x), jnp.asarray(pos))
    got, none = attention.mla_forward(cfg, tp, _t(x), _t(pos))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LAYER_TOL)

    rcache = ref_attn.init_mla_cache(cfg, b, cap, jnp.float32)
    cache = attention.init_cache(cfg, b, cap, torch.float32)
    assert set(cache) == {"c_kv", "k_rope", "pos", "idx"}
    steps_x = [(x, pos)] + [
        (rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32),
         np.full((b, 1), s + i, np.int32)) for i in range(3)]
    for xi, pi in steps_x:
        want, rcache = ref_mla(p, jnp.asarray(xi), jnp.asarray(pi),
                               cache=rcache)
        got, cache = attention.mla_forward(cfg, tp, _t(xi), _t(pi),
                                           cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LAYER_TOL)
        assert cache["idx"] == int(rcache["idx"])
        assert np.array_equal(cache["pos"].numpy(), np.asarray(rcache["pos"]))
        for key in ("c_kv", "k_rope"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(rcache[key]), rtol=0,
                                       atol=LAYER_TOL)


def test_mla_decode_launches_no_kernel_and_prefill_pads_v():
    """The absorbed decode never calls sdpa; the prefill hands sdpa one
    head dim, V padded from v_head_dim to qk_nope + qk_rope."""
    cfg, p, rng = _mla_setup()
    tp = bridge.to_torch(p)
    seen = []
    real = attention.sdpa

    def spy(q, k, v, *a, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return real(q, k, v, *a, **kw)
    attention.sdpa = spy
    try:
        cache = attention.init_cache(cfg, 1, 6, torch.float32)
        x = _t(rng.standard_normal((1, 5, cfg.d_model)).astype(np.float32))
        attention.mla_forward(cfg, tp, x, torch.arange(5)[None],
                              cache=cache)
        attention.mla_forward(cfg, tp, x[:, :1], torch.tensor([[5]]),
                              cache=cache)
    finally:
        attention.sdpa = real
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    assert seen == [(qk, qk, qk)]


# ---- the decoder stacks ----

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_lm_draws_the_references_tree(arch):
    """init_lm from a key: the reference's tree (prefix layers, stacked
    groups; MoE experts, MLA latents, Mamba mixers) and its numbers; the
    bridge's serving tree holds the same leaves layer by layer."""
    cfg = get_config(arch, smoke=True)
    want = _ref_params(arch)
    got = tf.init_lm(cfg, jax_prng.PRNGKey(0), torch.float32)
    got_l = list(bridge.tree_leaves_with_path(got))
    want_l = jax.tree_util.tree_leaves_with_path(want)
    assert len(got_l) == len(want_l)
    for (_, g), (_, w) in zip(got_l, want_l):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
    served = bridge.lm_params_from_reference(want, cfg)
    for layer, spec, ref_layer in zip(served["layers"], tf.layer_specs(cfg),
                                      tf.layer_params(cfg, got)):
        assert ("mixer" in layer) and (("a_log" in layer["mixer"])
                                       == (spec[0] == "ssm"))
        assert ("router" in layer["mlp"]) == spec[1]
        for g, w in zip(bridge.tree_leaves(layer),
                        bridge.tree_leaves(ref_layer)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-7)


def _assert_states(got, want_np, cfg):
    want = bridge.lm_states_from_reference(want_np, cfg)
    assert len(got) == len(want) == cfg.num_layers
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            if key == "idx":
                assert g[key] == w[key]
            elif key == "pos":
                assert torch.equal(g[key], w[key])
            else:
                np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                           rtol=LM_TOL, atol=LM_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """Full-sequence logits and aux; then a prefill of 12 tokens into a
    cache of 15 and 3 teacher-forced decode steps (MLA's absorbed, the
    Mamba layer's one-step scan): logits, aux and every layer's state
    within 1e-4."""
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch,
                                                             smoke=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    np_params = _ref_params(arch)
    params = bridge.lm_params_from_reference(np_params, cfg)
    rng = np.random.default_rng(4)
    b, s, extra = 2, 12, 3
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    want, _, w_aux = ref_tf.lm_forward(rcfg, np_params, tokens)
    got, _, aux = tf.lm_forward(cfg, params, _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LM_TOL,
                               atol=LM_TOL)
    assert float(aux) > 0 and abs(float(aux) - float(w_aux)) <= AUX_TOL

    rstates = ref_tf.init_states(rcfg, b, s + extra, jnp.float32)
    states = tf.init_states(cfg, b, s + extra, torch.float32)
    _assert_states(states, _np(rstates), cfg)
    want, rstates, _ = ref_tf.lm_forward(rcfg, np_params, tokens,
                                         states=rstates,
                                         logits_slice_last=True)
    got, states, _ = tf.lm_forward(cfg, params, _t(tokens), states=states,
                                   logits_slice_last=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LM_TOL,
                               atol=LM_TOL)
    _assert_states(states, _np(rstates), cfg)
    for i in range(extra):
        tok = rng.integers(0, cfg.vocab_size, (b, 1), dtype=np.int32)
        pos = np.full((b, 1), s + i, np.int32)
        want, rstates, w_aux = ref_tf.lm_forward(
            rcfg, np_params, tok, positions=pos, states=rstates,
            logits_slice_last=True)
        got, states, aux = tf.lm_forward(cfg, params, _t(tok),
                                         positions=_t(pos), states=states,
                                         logits_slice_last=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LM_TOL, atol=LM_TOL)
        assert abs(float(aux) - float(w_aux)) <= AUX_TOL
        _assert_states(states, _np(rstates), cfg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_fn_with_aux_and_grads_match_the_reference(arch):
    """Cross entropy plus the MoE aux term on the reference's tree from
    a key: the loss within rtol 1e-5, every gradient within 1e-5 (the
    router's too, through the aux term and the gates)."""
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch,
                                                             smoke=True)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :2] = -100
    batch = {"tokens": toks[:, :-1], "labels": labels}
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_tf.loss_fn(rcfg, p, jax.tree.map(jnp.asarray, batch))
    ))(_ref_params(arch))
    params = tf.init_lm(cfg, jax_prng.PRNGKey(0), torch.float32)
    layout = bridge.layout_of(params)
    leaves = [t.requires_grad_(True) for t in bridge.tree_leaves(params)]
    loss = tf.loss_fn(cfg, bridge.tree_map(lambda i: leaves[i],
                                           layout.skeleton),
                      {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= 1e-5 * float(want_loss)
    for g, w in zip(grads, jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=GRAD_ATOL)


def test_cohort_grads_under_vmap_match_one_client_at_a_time():
    """The FL trainer's vmap(grad) over a (K, N) stack of DeepSeek-V2
    SMOKE params (routing, stable sort, gather and scatter-add batched)
    equals each client's own gradient."""
    from torch.func import grad, vmap
    cfg = get_config(DEEPSEEK, smoke=True)
    flat, layout = bridge.load_params(
        tf.init_lm(cfg, jax_prng.PRNGKey(0), torch.float32))
    stack = torch.stack([flat, flat * 0.99])
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int64)
        batches.append({"tokens": _t(toks[:, :-1]),
                        "labels": _t(toks[:, 1:])})
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}

    def loss(w, batch):
        return tf.loss_fn(cfg, layout.unflatten(w), batch)
    got = vmap(grad(loss))(stack, stacked)
    for j in range(2):
        torch.testing.assert_close(got[j], grad(loss)(stack[j], batches[j]),
                                   rtol=1e-5, atol=1e-6)


# ---- the steps ----

def _same_specs(got, want):
    want = list(jax.tree_util.tree_leaves_with_path(want))
    got = list(bridge.tree_leaves_with_path(got))
    assert len(got) == len(want)
    for (_, g), (path, w) in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_specs_match_the_references_eval_shape(arch):
    """params_spec, states_spec and input_specs at full size (Kimi-K2's
    1T parameters as meta tensors), every shape."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    _same_specs(steps.params_spec(cfg), ref_steps.params_spec(rcfg))
    for name, shape in shapes.SHAPES.items():
        rshape = ref_shapes.SHAPES[name]
        _same_specs(steps.states_spec(cfg, shape),
                    ref_steps.states_spec(rcfg, rshape))
        _same_specs(steps.input_specs(cfg, shape),
                    ref_steps.input_specs(rcfg, rshape))


def test_grouped_train_step_matches_the_reference():
    """make_train_step(moe_groups=2) on DeepSeek-V2 SMOKE: two SGD steps,
    losses within rtol 1e-5 and params within 1e-5 of the reference's
    grouped step."""
    rcfg, cfg = ref_get_config(DEEPSEEK, smoke=True), get_config(
        DEEPSEEK, smoke=True)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (4, 9)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rstep = jax.jit(ref_steps.make_train_step(rcfg, lr=0.01, remat="none",
                                              moe_groups=2))
    step = steps.make_train_step(cfg, lr=0.01, remat="none", moe_groups=2)
    rparams = _ref_params(DEEPSEEK)
    params = tf.init_lm(cfg, jax_prng.PRNGKey(0), torch.float32)
    for _ in range(2):
        rparams, want = rstep(rparams, jax.tree.map(jnp.asarray, batch))
        params, loss = step(params, {k: _t(v) for k, v in batch.items()})
        assert abs(float(loss) - float(want)) <= 1e-5 * float(want)
    for g, w in zip(bridge.tree_leaves(params), jax.tree.leaves(rparams)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_expert_parallel_and_sharding_cite_item_13():
    """The expert-parallel MoE trains over a mesh (item 13c, ported):
    without one it raises; serving with it cites item 13i, and
    DeepSeek-V2 over a model group its MLA's item 13f."""
    cfg = get_config(DEEPSEEK, smoke=True)
    shape = shapes.SHAPES["prefill_32k"]
    with pytest.raises(ValueError, match="moe_mesh"):
        steps.make_train_step(cfg, moe_impl="ep")
    with pytest.raises(NotImplementedError, match="item 13f"):
        steps.make_train_step(cfg, model_group=object())
    assert callable(steps.make_decode_step(cfg, shape,
                                           shard_fn=lambda x, role: x))
    for make in (steps.make_prefill_step, steps.make_decode_step):
        with pytest.raises(NotImplementedError, match="item 13i"):
            make(cfg, shape, moe_impl="ep")
    with pytest.raises(ValueError, match="moe_mesh"):
        tf.lm_forward(cfg, {}, torch.zeros(1, 2, dtype=torch.int64),
                      moe_impl="ep")
