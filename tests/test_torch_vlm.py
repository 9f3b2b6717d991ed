"""LLaVA-NeXT's VLM trunk on the port against the JAX reference, on the
CPU: the config, the frontend stubs, prefill with the patch prefix then
teacher-forced decode against the reference's ``lm_forward`` (states of
capacity patches + prompt + steps, which the reference's ``serve_lm``
does not size: ROADMAP Queue 3), and ``serve_lm`` on a VLM."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import frontend as ref_frontend
from repro.models import transformer as ref_tf
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.core import jax_prng
from repro_torch.launch import serve
from repro_torch.models import frontend
from repro_torch.models import transformer as tf
from _torch_threads import one_intra_op_thread  # noqa: F401

VLM = "llava-next-mistral-7b"
ATOL = RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _ref_params():
    cfg = ref_get_config(VLM, smoke=True)
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: ref_tf.init_lm(cfg, k, jnp.float32))(jax.random.PRNGKey(0)))


def test_config_is_the_references():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(VLM, smoke=smoke)) == \
            dataclasses.asdict(ref_get_config(VLM, smoke=smoke))
    cfg = get_config(VLM)
    assert (cfg.arch_type, cfg.modality, cfg.num_patches) == \
        ("vlm", "vision", 576)


def test_frontend_stubs_have_the_references_shapes():
    gen = torch.Generator().manual_seed(0)
    x = frontend.vision_patch_stub(gen, 2, 16, 32)
    want = ref_frontend.vision_patch_stub(jax.random.PRNGKey(0), 2, 16, 32)
    assert tuple(x.shape) == want.shape and x.dtype == torch.bfloat16
    assert abs(float(x.float().std()) - 0.02) < 0.004
    a = frontend.audio_frame_stub(gen, 1, 30, 8, dtype=torch.float32)
    assert tuple(a.shape) == ref_frontend.audio_frame_stub(
        jax.random.PRNGKey(0), 1, 30, 8).shape and a.dtype == torch.float32


def test_vlm_prefill_and_decode_match_the_reference():
    """The reference's init (jax_prng, the stacked tree) on both sides:
    a full-sequence forward with patch embeddings, then a prefill of
    patches + prompt into states of P + S + steps slots and 3
    teacher-forced decode steps at positions P + S + i — logits and KV
    caches within 1e-4."""
    rcfg, cfg = ref_get_config(VLM, smoke=True), get_config(VLM, smoke=True)
    np_params = _ref_params()
    params = tf.init_lm(cfg, jax_prng.PRNGKey(0), torch.float32)
    rng = np.random.default_rng(0)
    b, s, steps, p = 2, 10, 3, cfg.num_patches
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    embeds = 0.02 * rng.standard_normal((b, p, cfg.d_model)).astype(
        np.float32)

    want, _, _ = ref_tf.lm_forward(rcfg, np_params, tokens, embeds=embeds)
    got, _, _ = tf.lm_forward(cfg, params, torch.from_numpy(tokens),
                              embeds=torch.from_numpy(embeds))
    assert tuple(got.shape) == (b, p + s, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)

    cap = p + s + steps
    rstates = ref_tf.init_states(rcfg, b, cap, jnp.float32)
    states = tf.init_states(cfg, b, cap, torch.float32)
    want, rstates, _ = ref_tf.lm_forward(rcfg, np_params, tokens,
                                         embeds=embeds, states=rstates,
                                         logits_slice_last=True)
    got, states, _ = tf.lm_forward(cfg, params, torch.from_numpy(tokens),
                                   embeds=torch.from_numpy(embeds),
                                   states=states, logits_slice_last=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for i in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (b, 1), dtype=np.int32)
        pos = np.full((b, 1), p + s + i, np.int32)
        want, rstates, _ = ref_tf.lm_forward(rcfg, np_params, tok,
                                             positions=pos, states=rstates,
                                             logits_slice_last=True)
        got, states, _ = tf.lm_forward(cfg, params, torch.from_numpy(tok),
                                       positions=torch.from_numpy(pos),
                                       states=states, logits_slice_last=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    want_states = bridge.lm_states_from_reference(
        jax.tree.map(np.asarray, rstates), cfg)
    for g, w in zip(states, want_states, strict=True):
        assert g["idx"] == w["idx"] == cap
        assert torch.equal(g["pos"], w["pos"])
        for key in ("k", "v"):
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       rtol=RTOL, atol=ATOL)


def test_serve_lm_on_a_vlm():
    """serve_lm prepends the stub's zero patch prefix, holds every patch
    in its cache (P + prompt + gen slots) and decodes at positions offset
    by P: its greedy tokens are a plain loop of full forwards over
    [zero patches, prompt, generated]."""
    cfg = get_config(VLM, smoke=True)
    gen = torch.Generator().manual_seed(3)
    params = tf.init_lm(cfg, gen, torch.float32)
    prompts = torch.randint(0, cfg.vocab_size, (2, 6), generator=gen)
    tokens, stats = serve.serve_lm(cfg, 2, 6, 4, device="cpu",
                                   params=params, prompts=prompts)
    assert tokens.shape == (2, 4) and set(stats) == {
        "prefill_s", "decode_s", "tok_per_s"}
    zeros = torch.zeros(2, cfg.num_patches, cfg.d_model)
    seq = prompts
    for _ in range(4):
        logits, _, _ = tf.lm_forward(cfg, params, seq, embeds=zeros)
        seq = torch.cat([seq, logits[:, -1].argmax(-1)[:, None]], dim=1)
    assert torch.equal(seq[:, 6:], tokens)


def test_embeddings_need_a_vlm():
    cfg = get_config("starcoder2-3b", smoke=True)
    with pytest.raises(ValueError, match="VLM's patch embeddings only"):
        tf.lm_forward(cfg, {}, torch.zeros(1, 2, dtype=torch.int64),
                      embeds=torch.zeros(1, 1, cfg.d_model))
    with pytest.raises(NotImplementedError, match="modality='text'"):
        tf.init_lm(get_config(VLM, smoke=True).with_(modality="text"),
                   torch.Generator())
