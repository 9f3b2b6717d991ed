"""repro_torch's decoders and serving against the reference: the four
dense SMOKE configs and the pure-SSM Falcon-Mamba SMOKE config from the
reference's ``init_lm`` params, carried across by the bridge —
full-sequence logits, then prefill plus teacher-forced decode steps
(logits and caches or SSM states) — and the serve entry points on the
CPU."""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import transformer as ref_tf
from repro_torch import bridge
from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
DENSE = ("starcoder2-3b", "phi4-mini-3.8b", "minitron-8b", "command-r-35b")
SSM = "falcon-mamba-7b"
# f32 matmuls in other orders through two layers: a few 1e-6 of the logits
ATOL = RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_get_config(arch, smoke=True)
    params = jax.jit(lambda k: ref_tf.init_lm(cfg, k, jnp.float32))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_states_match(got, want_np, cfg):
    want = bridge.lm_states_from_reference(want_np, cfg)
    assert len(got) == len(want) == cfg.num_layers
    for g, w in zip(got, want):
        assert g["idx"] == w["idx"]
        assert torch.equal(g["pos"], w["pos"])
        for key in ("k", "v"):
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_prefill_and_decode_match_reference(arch):
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)   # copied
    np_params = _ref_params(arch)
    params = bridge.lm_params_from_reference(np_params, cfg)
    rng = np.random.default_rng(0)
    b, s, extra = 2, 12, 3
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)

    want, _, _ = ref_tf.lm_forward(rcfg, np_params, tokens)
    got, none, aux = tf.lm_forward(cfg, params, torch.from_numpy(tokens))
    assert none is None and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)

    # prefill into a cache of s + extra slots, then teacher-forced decode
    rstates = ref_tf.init_states(rcfg, b, s + extra, jnp.float32)
    states = tf.init_states(cfg, b, s + extra, torch.float32)
    _assert_states_match(states, _numpy(rstates), cfg)
    want, rstates, _ = ref_tf.lm_forward(rcfg, np_params, tokens,
                                         states=rstates,
                                         logits_slice_last=True)
    got, states, _ = tf.lm_forward(cfg, params, torch.from_numpy(tokens),
                                   states=states, logits_slice_last=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    _assert_states_match(states, _numpy(rstates), cfg)
    for i in range(extra):
        tok = rng.integers(0, cfg.vocab_size, (b, 1), dtype=np.int32)
        pos = np.full((b, 1), s + i, np.int32)
        want, rstates, _ = ref_tf.lm_forward(rcfg, np_params, tok,
                                             positions=pos, states=rstates,
                                             logits_slice_last=True)
        got, states, _ = tf.lm_forward(cfg, params, torch.from_numpy(tok),
                                       positions=torch.from_numpy(pos),
                                       states=states, logits_slice_last=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        _assert_states_match(states, _numpy(rstates), cfg)


@pytest.mark.parametrize("arch", DENSE)
def test_init_lm_has_the_reference_tree(arch):
    """The port's own init: the bridged reference tree's leaves, shapes
    and dtypes, and the reference's distributions."""
    cfg = get_config(arch, smoke=True)
    want = bridge.lm_params_from_reference(_ref_params(arch), cfg)
    got = tf.init_lm(cfg, torch.Generator().manual_seed(0), torch.float32)
    g_leaves = bridge.tree_leaves_with_path(got)
    w_leaves = bridge.tree_leaves_with_path(want)
    for (gp, g), (wp, w) in zip(g_leaves, w_leaves, strict=True):
        assert gp == wp and g.shape == w.shape and g.dtype == w.dtype
    assert abs(float(got["embed"].std()) - 0.02) < 0.002
    wq = got["layers"][0]["mixer"]["wq"]["w"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    bf16 = tf.init_lm(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in bridge.tree_leaves(bf16))


def test_serve_lm_on_cpu():
    cfg = get_config("starcoder2-3b", smoke=True)
    tokens, stats = serve.serve_lm(cfg, 3, 10, 5, seed=1, device="cpu")
    assert tokens.shape == (3, 5) and tokens.dtype == torch.int64
    assert bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s"}
    # the seed draws params, then prompts; given both, the same run
    gen = torch.Generator().manual_seed(1)
    params = tf.init_lm(cfg, gen, torch.float32)
    prompts = torch.randint(0, cfg.vocab_size, (3, 10), generator=gen)
    again, _ = serve.serve_lm(cfg, 3, 10, 5, seed=7, device="cpu",
                              params=params, prompts=prompts)
    assert torch.equal(tokens, again)
    # greedy tokens equal a plain loop of lm_forward on the same params
    seq = prompts
    for _ in range(5):
        logits, _, _ = tf.lm_forward(cfg, params, seq)
        seq = torch.cat([seq, logits[:, -1].argmax(-1)[:, None]], dim=1)
    assert torch.equal(seq[:, 10:], tokens)
    bf16, _ = serve.serve_lm(cfg, 2, 6, 3, device="cpu",
                             dtype=torch.bfloat16)
    assert bf16.shape == (2, 3)


def test_serve_lm_refuses_a_missing_card_and_bad_prompts():
    cfg = get_config("starcoder2-3b", smoke=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.serve_lm(cfg, 1, 4, 2)
    with pytest.raises(ValueError, match="prompts"):
        serve.serve_lm(cfg, 2, 4, 2, device="cpu",
                       prompts=torch.zeros(2, 5, dtype=torch.int64))


def test_serve_cli_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "starcoder2-3b", "--batch", "2", "--gen", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "generated (2, 4) tokens on cpu" in proc.stdout


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-1.5-large-398b",
                                  "whisper-base"])
def test_unported_archs_raise(arch):
    """Every arch id is ported now: full and SMOKE configs build (the
    reference's numbers); an unknown id raises, and so does a forward
    with the expert-parallel MoE and states but no mesh: it serves over
    a (data, model) mesh (item 13i, ported: tests/test_torch_tp_serve.py)
    and without one raises a ValueError naming moe_mesh."""
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
            dataclasses.asdict(ref_get_config(arch, smoke=smoke))
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    with pytest.raises(ValueError, match="moe_mesh"):
        tf.lm_forward(get_config(arch, smoke=True), {},
                      torch.zeros(1, 2, dtype=torch.int64), moe_impl="ep",
                      states=[])


def test_non_dense_layers_raise():
    """MoE, hybrid and MLA stacks build, prefill and serve now (held
    against the reference in test_torch_moe.py); what still raises: an
    embedding prefix outside a VLM, an SSM stack with MoE layers (it has
    no MLP) and serving with the expert-parallel MoE without its mesh
    (with one it serves: tests/test_torch_tp_serve.py)."""
    moe = ArchConfig(name="tiny-moe", arch_type="moe", moe=True,
                     num_experts=4, top_k=2, moe_d_ff=64, d_model=32,
                     num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64)
    params = tf.init_lm(moe, torch.Generator())
    logits, _, aux = tf.lm_forward(moe, params,
                                   torch.zeros(1, 3, dtype=torch.int64))
    assert logits.shape == (1, 3, 64) and float(aux) > 0
    dense = get_config("starcoder2-3b", smoke=True)
    with pytest.raises(ValueError, match="encdec"):
        tf.lm_forward(dense, {}, torch.zeros(1, 2, dtype=torch.int64),
                      embeds=torch.zeros(1, 1, dense.d_model))
    # the hybrid stack (Jamba: SSM layers, attention every 2nd, MoE)
    # builds its states and serves
    hybrid = ArchConfig(**dataclasses.asdict(
        ref_get_config("jamba-1.5-large-398b", smoke=True)))
    assert hybrid.arch_type == "hybrid"
    states = tf.init_states(hybrid, 1, 4, torch.float32)
    assert [set(st) for st in states] == [{"conv", "h"},
                                          {"k", "v", "pos", "idx"}]
    tokens, _ = serve.serve_lm(hybrid, 1, 4, 2, device="cpu")
    assert tokens.shape == (1, 2)
    with pytest.raises(ValueError, match="moe_mesh"):
        tf.lm_forward(hybrid, {}, torch.zeros(1, 2, dtype=torch.int64),
                      moe_impl="ep", states=states)
    # an SSM stack with MoE layers does not pass
    ssm_moe = get_config(SSM, smoke=True).with_(moe=True, num_experts=4,
                                                top_k=2, moe_d_ff=64)
    with pytest.raises(NotImplementedError, match="with MoE"):
        tf.init_lm(ssm_moe, torch.Generator())


# ---- the pure-SSM stack (Falcon-Mamba SMOKE) ----

def _assert_ssm_states_match(got, want_np, cfg):
    want = bridge.lm_states_from_reference(want_np, cfg)
    assert len(got) == len(want) == cfg.num_layers
    for g, w in zip(got, want):
        assert set(g) == {"conv", "h"} and g["h"].dtype == torch.float32
        for key in ("conv", "h"):
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       rtol=RTOL, atol=ATOL)


def test_ssm_lm_forward_prefill_and_decode_match_reference():
    """Full-sequence logits; prefill into zero states, then 4
    teacher-forced decode steps: logits and {conv, h} states."""
    rcfg, cfg = ref_get_config(SSM, smoke=True), get_config(SSM, smoke=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)   # copied
    np_params = _ref_params(SSM)
    params = bridge.lm_params_from_reference(np_params, cfg)
    assert set(params["layers"][0]) == {"norm1", "mixer"}
    rng = np.random.default_rng(0)
    b, s, steps = 2, 12, 4
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)

    want, _, _ = ref_tf.lm_forward(rcfg, np_params, tokens)
    got, none, aux = tf.lm_forward(cfg, params, torch.from_numpy(tokens))
    assert none is None and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)

    rstates = ref_tf.init_states(rcfg, b, s + steps, jnp.float32)
    states = tf.init_states(cfg, b, s + steps, torch.float32)
    _assert_ssm_states_match(states, _numpy(rstates), cfg)
    want, rstates, _ = ref_tf.lm_forward(rcfg, np_params, tokens,
                                         states=rstates,
                                         logits_slice_last=True)
    got, states, _ = tf.lm_forward(cfg, params, torch.from_numpy(tokens),
                                   states=states, logits_slice_last=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    _assert_ssm_states_match(states, _numpy(rstates), cfg)
    for i in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (b, 1), dtype=np.int32)
        pos = np.full((b, 1), s + i, np.int32)
        want, rstates, _ = ref_tf.lm_forward(rcfg, np_params, tok,
                                             positions=pos, states=rstates,
                                             logits_slice_last=True)
        got, states, _ = tf.lm_forward(cfg, params, torch.from_numpy(tok),
                                       positions=torch.from_numpy(pos),
                                       states=states, logits_slice_last=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        _assert_ssm_states_match(states, _numpy(rstates), cfg)


def test_init_lm_ssm_has_the_reference_tree():
    """The port's own init of the pure-SSM stack: the bridged reference
    tree's leaves, shapes and dtypes (a_log and d_skip f32 in a bf16
    model too)."""
    cfg = get_config(SSM, smoke=True)
    want = bridge.lm_params_from_reference(_ref_params(SSM), cfg)
    for dtype in (torch.float32, torch.bfloat16):
        got = tf.init_lm(cfg, torch.Generator().manual_seed(0), dtype)
        g_leaves = bridge.tree_leaves_with_path(got)
        w_leaves = bridge.tree_leaves_with_path(want)
        for (gp, g), (wp, w) in zip(g_leaves, w_leaves, strict=True):
            f32 = gp[-1] in ("a_log", "d_skip")
            assert gp == wp and g.shape == w.shape, gp
            assert g.dtype == (torch.float32 if f32 else dtype), gp
    assert abs(float(got["embed"].float().std()) - 0.02) < 0.002
    states = tf.init_states(cfg, 3, 99, torch.bfloat16)
    assert [tuple(st["conv"].shape) for st in states] == \
        [(3, cfg.ssm_conv - 1, cfg.ssm_d_inner)] * cfg.num_layers
    assert all(st["conv"].dtype == torch.bfloat16
               and st["h"].dtype == torch.float32 for st in states)


def test_serve_ssm_lm_on_cpu():
    cfg = get_config(SSM, smoke=True)
    tokens, stats = serve.serve_lm(cfg, 3, 10, 5, seed=1, device="cpu")
    assert tokens.shape == (3, 5) and tokens.dtype == torch.int64
    assert bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s"}
    gen = torch.Generator().manual_seed(1)
    params = tf.init_lm(cfg, gen, torch.float32)
    prompts = torch.randint(0, cfg.vocab_size, (3, 10), generator=gen)
    # on CPU tensors "auto" is the plain scan: the same tokens as asking
    # for it, and as a plain loop of full-sequence forwards
    again, _ = serve.serve_lm(cfg, 3, 10, 5, device="cpu", params=params,
                              prompts=prompts, ssm_impl="reference")
    assert torch.equal(tokens, again)
    seq = prompts
    for _ in range(5):
        logits, _, _ = tf.lm_forward(cfg, params, seq)
        seq = torch.cat([seq, logits[:, -1].argmax(-1)[:, None]], dim=1)
    assert torch.equal(seq[:, 10:], tokens)
    bf16, _ = serve.serve_lm(cfg, 2, 6, 3, device="cpu",
                             dtype=torch.bfloat16)
    assert bf16.shape == (2, 3)


def test_serve_cli_ssm_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", SSM, "--batch", "2", "--gen", "4", "--dtype",
         "bfloat16"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "generated (2, 4) tokens on cpu" in proc.stdout


# ---- bf16 models against the reference's bf16 models ----

@functools.lru_cache(maxsize=None)
def _ref_params_bf16(arch):
    cfg = ref_get_config(arch, smoke=True)
    params = jax.jit(lambda k: ref_tf.init_lm(cfg, k, jnp.bfloat16))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _bf16_step(x: float) -> float:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "phi4-mini-3.8b", SSM])
def test_bf16_lm_forward_matches_reference_bf16(arch):
    """The reference's bf16 init_lm carried across by the bridge: a prefill
    of 2 x 12 tokens, then 4 teacher-forced decode steps, both packages in
    bf16. The two round bf16 activations at other points (fused XLA ops
    against eager PyTorch), so the logits are held within 4 bf16 steps at
    max|logit|, and top-1 only on rows whose reference margin between its
    top two logits exceeds that tolerance."""
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    np_params = _ref_params_bf16(arch)
    params = bridge.lm_params_from_reference(np_params, cfg)
    assert params["embed"].dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    b, s, steps = 2, 12, 4
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    rstates = ref_tf.init_states(rcfg, b, s + steps, jnp.bfloat16)
    states = tf.init_states(cfg, b, s + steps, torch.bfloat16)
    wants, gots = [], []
    want, rstates, _ = ref_tf.lm_forward(rcfg, np_params, tokens,
                                         states=rstates,
                                         logits_slice_last=True)
    got, states, _ = tf.lm_forward(cfg, params, torch.from_numpy(tokens),
                                   states=states, logits_slice_last=True)
    wants.append(want[:, -1])
    gots.append(got[:, -1])
    for i in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (b, 1), dtype=np.int32)
        pos = np.full((b, 1), s + i, np.int32)
        want, rstates, _ = ref_tf.lm_forward(rcfg, np_params, tok,
                                             positions=pos, states=rstates,
                                             logits_slice_last=True)
        got, states, _ = tf.lm_forward(cfg, params, torch.from_numpy(tok),
                                       positions=torch.from_numpy(pos),
                                       states=states, logits_slice_last=True)
        wants.append(want[:, -1])
        gots.append(got[:, -1])
    want = np.stack([np.asarray(w, np.float32) for w in wants])
    got = torch.stack(gots).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    tol = 4 * _bf16_step(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > tol
    assert np.array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])
