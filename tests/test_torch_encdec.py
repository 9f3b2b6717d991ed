"""The encoder-decoder (Whisper-base) of the port against the reference, on
the CPU, from the same numpy inputs and the reference's params: the
encoder's sinusoidal table bit for bit, ``encode``, ``decode`` (teacher
forced, and step by step against the caches) and ``encdec_loss_fn``
with its gradients, ``serve_encdec``'s tokens on the reference's own
params and frames, the serve CLI, the steps (train, prefill, decode) and
their specs against the reference's ``eval_shape``s.

Tolerances: f32 products summed in other orders — encoder outputs,
logits, caches and gradients within 1e-5, losses within rtol 1e-5."""
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

from repro.configs import shapes as ref_shapes
from repro.configs.base import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.launch import steps as ref_steps
from repro.models import encdec as ref_encdec
from repro.models.layers import sinusoidal_positions as ref_sinusoid
from repro_torch import bridge
from repro_torch.configs import shapes
from repro_torch.configs.base import get_config
from repro_torch.core import jax_prng
from repro_torch.launch import serve, steps
from repro_torch.models import encdec
from repro_torch.models.layers import sinusoidal_positions
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-base"
TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _ref_params(seed=0):
    cfg = ref_get_config(ARCH, smoke=True)
    return _np(jax.jit(lambda k: ref_encdec.init_encdec(cfg, k, jnp.float32))(
        jax.random.PRNGKey(seed)))


def _cfgs():
    return ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)


def _frames(cfg, b=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("t,d", [(1500, 512), (64, 128), (7, 10)])
def test_sinusoidal_positions_bit_for_bit(t, d):
    """Whisper-base's table (1,500 x 512), SMOKE's and an odd shape."""
    got = sinusoidal_positions(t, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, d)
    assert np.array_equal(got.numpy(), np.asarray(ref_sinusoid(t, d)))


def test_init_encdec_draws_the_references_params():
    """From a key: the reference's tree (encoder and decoder stacked over
    layers), key paths' leaf order and numbers; the bridge's serving tree
    holds the same layers as lists."""
    cfg = get_config(ARCH, smoke=True)
    got = encdec.init_encdec(cfg, jax_prng.PRNGKey(0), torch.float32)
    want = _ref_params()
    got_l = list(bridge.tree_leaves_with_path(got))
    want_l = jax.tree_util.tree_leaves_with_path(want)
    assert len(got_l) == len(want_l)
    for (_, g), (_, w) in zip(got_l, want_l):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
    served = bridge.encdec_params_from_reference(want, cfg)
    assert len(served["encoder"]) == cfg.encoder_layers
    assert len(served["decoder"]) == cfg.num_layers
    np.testing.assert_array_equal(
        served["decoder"][1]["cross_attn"]["wk"]["w"].numpy(),
        want["decoder"]["cross_attn"]["wk"]["w"][1])
    gen = encdec.init_encdec(cfg, torch.Generator().manual_seed(0))
    assert bridge.tree_map(lambda x: tuple(x.shape), gen) == \
        bridge.tree_map(lambda x: tuple(x.shape), served)


def test_encode_and_teacher_forced_decode_match_the_reference():
    """encode (bidirectional, every frame visible) and a teacher-forced
    decode (causal self-attention, cross-attention over all frames) on
    both trees: within 1e-5."""
    rcfg, cfg = _cfgs()
    np_params = _ref_params()
    frames = _frames(cfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9),
                                               dtype=np.int32)
    want_enc = jax.jit(functools.partial(ref_encdec.encode, rcfg))(
        np_params, jnp.asarray(frames))
    want, _ = jax.jit(functools.partial(ref_encdec.decode, rcfg))(
        np_params, jnp.asarray(tokens), want_enc)
    for params in (bridge.encdec_params_from_reference(np_params, cfg),
                   encdec.init_encdec(cfg, jax_prng.PRNGKey(0),
                                      torch.float32)):
        enc = encdec.encode(cfg, params, _t(frames))
        np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc),
                                   rtol=0, atol=TOL)
        got, none = encdec.decode(cfg, params, _t(tokens), enc)
        assert none is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)


def test_cached_decode_step_by_step_matches_the_reference():
    """A prefill of 4 tokens into caches of 8, then 3 decode steps: the
    logits and every layer's cache within 1e-5, positions and idx
    exact."""
    rcfg, cfg = _cfgs()
    np_params = _ref_params()
    params = bridge.encdec_params_from_reference(np_params, cfg)
    frames = _frames(cfg, seed=2)
    enc = jnp.asarray(np.asarray(jax.jit(functools.partial(
        ref_encdec.encode, rcfg))(np_params, jnp.asarray(frames))))
    ref_decode = jax.jit(functools.partial(ref_encdec.decode, rcfg))
    rstates = ref_encdec.init_decoder_states(rcfg, 2, 8, jnp.float32)
    states = encdec.init_decoder_states(cfg, 2, 8, torch.float32)
    rng = np.random.default_rng(3)
    feeds = [rng.integers(0, cfg.vocab_size, (2, 4), dtype=np.int32)] + [
        rng.integers(0, cfg.vocab_size, (2, 1), dtype=np.int32)
        for _ in range(3)]
    start = 0
    for tok in feeds:
        s = tok.shape[1]
        pos = np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                              (2, s)).copy()
        start += s
        want, rstates = ref_decode(np_params, jnp.asarray(tok), enc,
                                   jnp.asarray(pos), states=rstates)
        got, states = encdec.decode(cfg, params, _t(tok), _t(enc), _t(pos),
                                    states=states)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)
        for g, w in zip(states,
                        bridge.encdec_states_from_reference(_np(rstates),
                                                            cfg)):
            assert g["idx"] == w["idx"] == start
            assert torch.equal(g["pos"], w["pos"])
            for key in ("k", "v"):
                np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                           rtol=0, atol=TOL)


def _loss_batch(cfg, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[1, :3] = -100
    return {"frames": _frames(cfg, seed=seed), "tokens": toks[:, :-1],
            "labels": labels}


def test_encdec_loss_fn_and_grads_match_the_reference():
    """Teacher-forced cross entropy with -100 labels: the loss within
    rtol 1e-5, every gradient (encoder, decoder, cross-attention,
    embedding) within 1e-5."""
    rcfg, cfg = _cfgs()
    batch = _loss_batch(cfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_encdec.encdec_loss_fn(
            rcfg, p, jax.tree.map(jnp.asarray, batch))))(_ref_params())
    params = encdec.init_encdec(cfg, jax_prng.PRNGKey(0), torch.float32)
    layout = bridge.layout_of(params)
    leaves = [t.requires_grad_(True) for t in bridge.tree_leaves(params)]
    loss = encdec.encdec_loss_fn(
        cfg, bridge.tree_map(lambda i: leaves[i], layout.skeleton),
        {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want_loss)) \
        <= 1e-5 * float(want_loss)
    for g, w in zip(grads, jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)


def test_serve_encdec_repeats_the_references_tokens():
    """The reference's serve_encdec (params and frames from PRNGKey(0))
    and the port's on those params and frames, carried across: the same
    greedy tokens; the CLI prints them for --arch whisper-base."""
    rcfg, cfg = _cfgs()
    b, gen = 2, 6
    want, _ = ref_serve.serve_encdec(rcfg, b, gen, seed=0)
    key = jax.random.PRNGKey(0)
    frames = np.asarray(jax.random.normal(
        key, (b, cfg.encoder_seq_len, cfg.d_model), jnp.float32))
    tokens, stats = serve.serve_encdec(
        cfg, b, gen, device="cpu",
        params=bridge.encdec_params_from_reference(_ref_params(), cfg),
        frames=_t(frames))
    assert tokens.shape == (b, gen)
    assert np.array_equal(tokens.numpy(), np.asarray(want))
    assert set(stats) == {"encode_s", "decode_s", "total_s", "tok_per_s"}
    with pytest.raises(ValueError, match="frames must be"):
        serve.serve_encdec(cfg, b, gen, device="cpu", frames=_t(frames[:1]))
    with pytest.raises(ValueError, match="serve_encdec"):
        serve.serve_lm(cfg, b, 4, 2, device="cpu")


def test_serve_cli_whisper_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--batch", "2", "--gen", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "generated (2, 4) tokens on cpu" in proc.stdout


# ---- the steps ----

def _same_specs(got, want):
    want = list(jax.tree_util.tree_leaves_with_path(want))
    got = list(bridge.tree_leaves_with_path(got))
    assert len(got) == len(want)
    for (_, g), (path, w) in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path


def test_specs_match_the_references_eval_shape():
    """params_spec, states_spec ({"decoder": stacked caches, "enc_out"})
    and input_specs (frames and min(seq_len, 448) decoder tokens) at full
    size, every shape."""
    rcfg, cfg = ref_get_config(ARCH), get_config(ARCH)
    _same_specs(steps.params_spec(cfg), ref_steps.params_spec(rcfg))
    for name, shape in shapes.SHAPES.items():
        rshape = ref_shapes.SHAPES[name]
        _same_specs(steps.states_spec(cfg, shape),
                    ref_steps.states_spec(rcfg, rshape))
        _same_specs(steps.input_specs(cfg, shape),
                    ref_steps.input_specs(rcfg, rshape))


def test_train_prefill_and_decode_steps_match_the_reference():
    """Two SGD steps of make_train_step (params within 1e-5, losses within
    rtol 1e-5), then make_prefill_step and make_decode_step on the
    trained params: the last-token logits within 1e-5 and enc_out
    carried."""
    rcfg, cfg = _cfgs()
    batch = _loss_batch(cfg, seed=5)
    rstep = jax.jit(ref_steps.make_train_step(rcfg, lr=0.05))
    step = steps.make_train_step(cfg, lr=0.05)
    rparams = _ref_params()
    params = encdec.init_encdec(cfg, jax_prng.PRNGKey(0), torch.float32)
    for _ in range(2):
        rparams, want = rstep(rparams, jax.tree.map(jnp.asarray, batch))
        params, loss = step(params, {k: _t(v) for k, v in batch.items()})
        assert abs(float(loss) - float(want)) <= 1e-5 * float(want)
    for g, w in zip(bridge.tree_leaves(params), jax.tree.leaves(rparams)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)

    shape = shapes.SHAPES["prefill_32k"]
    rshape = ref_shapes.SHAPES["prefill_32k"]
    cap = 8
    rstates = {"decoder": ref_encdec.init_decoder_states(rcfg, 2, cap,
                                                         jnp.float32)}
    states = {"decoder": encdec.init_decoder_states(cfg, 2, cap,
                                                    torch.float32)}
    frames, toks = batch["frames"], batch["tokens"][:, :5]
    rst, want = jax.jit(ref_steps.make_prefill_step(rcfg, rshape))(
        rparams, rstates, jnp.asarray(frames), jnp.asarray(toks))
    st, got = steps.make_prefill_step(cfg, shape)(params, states, _t(frames),
                                                  _t(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(st["enc_out"].numpy(),
                               np.asarray(rst["enc_out"]), rtol=0, atol=TOL)
    tok = np.argmax(np.asarray(want)[:, -1], axis=-1)[:, None].astype(
        np.int32)
    pos = np.full((2, 1), 5, np.int32)
    decode = steps.make_decode_step(cfg, shapes.SHAPES["decode_32k"])
    rst, want = jax.jit(ref_steps.make_decode_step(
        rcfg, ref_shapes.SHAPES["decode_32k"]))(
        rparams, rst, jnp.asarray(tok), jnp.asarray(pos))
    st2, got = decode(params, st, _t(tok), _t(pos))
    assert st2["enc_out"] is st["enc_out"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
