"""Federated LM training on the port against the JAX reference, on the
CPU: ``init_lm`` from a jax_prng key (the reference's tree and numbers),
``transformer.loss_fn`` and its gradients, ``launch/steps`` (the train
step at every remat and microbatch count, the meta-tensor specs against
``jax.eval_shape``), the LM training CLI, an LM checkpoint resumed by the
other package, and the kernel wrappers' refusal of training inputs."""
import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs import shapes as ref_shapes
from repro.configs.base import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.launch import train as ref_train
from repro.models import transformer as ref_tf
from repro_torch import bridge
from repro_torch.configs import shapes
from repro_torch.configs.base import get_config
from repro_torch.core import jax_prng
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.launch import steps
from repro_torch.launch import train
from repro_torch.models import transformer as tf
from _torch_threads import one_intra_op_thread  # noqa: F401

DENSE, SSM, VLM = "starcoder2-3b", "falcon-mamba-7b", "llava-next-mistral-7b"
ARCHS = (DENSE, SSM, VLM)
LOSS_RTOL, GRAD_ATOL, PARAM_ATOL = 1e-5, 1e-5, 1e-5


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    """The reference's SMOKE init from PRNGKey(0), f32, as numpy."""
    cfg = ref_get_config(arch, smoke=True)
    return jax.tree.map(np.asarray, jax.jit(functools.partial(
        ref_tf.init_lm, cfg, dtype=jnp.float32))(jax.random.PRNGKey(0)))


def port_params(arch):
    return tf.init_lm(get_config(arch, smoke=True), jax_prng.PRNGKey(0),
                      torch.float32)


def lm_batch(arch, b=2, s=12, seed=0):
    """Tokens and next-token labels (some -100) from a seed; a VLM's
    patch embeddings too."""
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100
    batch = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.modality == "vision":
        batch["patch_embeds"] = 0.02 * rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_draws_the_references_params(arch):
    """The reference's tree (prefix_layers, stacked groups), key paths and
    leaf order, and its numbers within a few f32 ulp (jax_prng.normal)."""
    want = list(jax.tree_util.tree_leaves_with_path(ref_params(arch)))
    got = list(bridge.tree_leaves_with_path(port_params(arch)))
    assert len(got) == len(want)
    tree = port_params(arch)
    for (path, g), (wpath, w) in zip(got, want):
        assert bridge.jax_keystr(tree, path) == \
            jax.tree_util.keystr(wpath, simple=True, separator="/") or \
            bridge.jax_keystr(tree, path) == "/".join(
                str(k) for k in wpath), (path, wpath)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_the_reference(arch):
    """Causal-LM CE with -100 labels (a VLM's patch logits sliced off):
    the loss within rtol 1e-5, every gradient within 1e-5."""
    rcfg = ref_get_config(arch, smoke=True)
    batch = lm_batch(arch)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: ref_tf.loss_fn(rcfg, p, jax.tree.map(jnp.asarray, batch))
    )(ref_params(arch))
    params = port_params(arch)
    layout = bridge.layout_of(params)
    leaves = [t.requires_grad_(True) for t in bridge.tree_leaves(params)]
    loss = tf.loss_fn(get_config(arch, smoke=True),
                      bridge.tree_map(lambda i: leaves[i], layout.skeleton),
                      _torch(batch))
    grads = torch.autograd.grad(loss, leaves)
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= LOSS_RTOL * float(want_loss)
    for g, w in zip(grads, jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=GRAD_ATOL)


def test_cohort_grads_under_vmap_match_one_client_at_a_time():
    """The trainer's vmap(grad) over a (K, N) stack of Falcon-Mamba
    params (the plain scan batched) equals each client's own gradient."""
    arch = SSM
    cfg = get_config(arch, smoke=True)
    params = port_params(arch)
    flat, layout = bridge.load_params(params)
    stack = torch.stack([flat, flat * 0.99])
    batches = [_torch(lm_batch(arch, seed=s)) for s in (1, 2)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}

    def loss(w, batch):
        return tf.loss_fn(cfg, layout.unflatten(w), batch)
    got = vmap(grad(loss))(stack, stacked)
    for j in range(2):
        want = grad(loss)(stack[j], batches[j])
        torch.testing.assert_close(got[j], want, rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _ref_steps(microbatches):
    cfg = ref_get_config(DENSE, smoke=True)
    step = jax.jit(ref_steps.make_train_step(cfg, lr=0.01, remat="none",
                                             microbatches=microbatches))
    params, losses = ref_params(DENSE), []
    batch = jax.tree.map(jnp.asarray, lm_batch(DENSE, b=4, s=16))
    for _ in range(2):
        params, loss = step(params, batch)
        losses.append(float(loss))
    return jax.tree.map(np.asarray, params), losses


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_matches_the_reference(remat, microbatches):
    """Two SGD steps of make_train_step (the reference's
    test_microbatched_train_step_equivalence, against the reference):
    params within 1e-5, losses within rtol 1e-5, at every remat (which
    changes what is stored, not the numbers) and microbatch count."""
    want, want_losses = _ref_steps(microbatches)
    step = steps.make_train_step(get_config(DENSE, smoke=True), lr=0.01,
                                 remat=remat, microbatches=microbatches)
    params = port_params(DENSE)
    batch = _torch(lm_batch(DENSE, b=4, s=16))
    for want_loss in want_losses:
        params, loss = step(params, batch)
        assert abs(float(loss) - want_loss) <= LOSS_RTOL * want_loss
    for g, w in zip(bridge.tree_leaves(params), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=PARAM_ATOL)


def _same_specs(got, want):
    want = list(jax.tree_util.tree_leaves_with_path(want))
    got = list(bridge.tree_leaves_with_path(got))
    assert len(got) == len(want)
    for (_, g), (path, w) in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_references_eval_shape(arch):
    """params_spec, states_spec and input_specs at full size, every
    shape: meta tensors of the reference's ShapeDtypeStructs, leaf for
    leaf in the reference's trees."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    _same_specs(steps.params_spec(cfg), ref_steps.params_spec(rcfg))
    for name, shape in shapes.SHAPES.items():
        rshape = ref_shapes.SHAPES[name]
        assert shape == shapes.get_shape(name)
        assert steps.cache_capacity(cfg, shape) == \
            ref_steps.cache_capacity(rcfg, rshape)
        _same_specs(steps.states_spec(cfg, shape),
                    ref_steps.states_spec(rcfg, rshape))
        _same_specs(steps.input_specs(cfg, shape),
                    ref_steps.input_specs(rcfg, rshape))


def test_steps_refuse_what_is_not_ported():
    """Only the multi-device options not yet ported raise, citing item
    13: serving with the expert-parallel MoE (item 13i; its training
    step is ported, test_torch_moe_parallel.py) and the tensor-parallel
    step of a family without a Megatron form in the port (an SSM stack,
    item 13g); ``shard_fn`` builds the steps (the MoE layers call it,
    test_torch_tensor_parallel.py), as do an encoder-decoder and MoE
    groups (held against the reference in test_torch_encdec.py and
    test_torch_moe.py)."""
    cfg = get_config(DENSE, smoke=True)
    with pytest.raises(NotImplementedError, match="item 13i"):
        steps.make_prefill_step(cfg, shapes.SHAPES["prefill_32k"],
                                moe_impl="ep")
    with pytest.raises(NotImplementedError, match="item 13g"):
        steps.make_train_step(get_config(SSM, smoke=True),
                              model_group=object())
    assert callable(steps.make_prefill_step(
        cfg, shapes.SHAPES["prefill_32k"], shard_fn=lambda x, role: x))
    fn, specs, has_states = steps.make_step(
        get_config("whisper-base", smoke=True), shapes.SHAPES["train_4k"])
    assert callable(fn) and not has_states and "frames" in specs["batch"]
    assert callable(steps.make_train_step(cfg, moe_groups=4))


# ---- the training CLI on the LM task ----

CLI = ["--seq-len", "33", "--rounds", "2", "--clients", "4",
       "--participation", "0.5", "--batch-size", "4", "--eval-every", "1"]
_NUMBERS = re.compile(r"loss=(-?[0-9.]+)\s+acc=(-?[0-9.]+)")


def _printed(out):
    return [tuple(map(float, m.groups())) for m in _NUMBERS.finditer(out)]


@pytest.fixture(scope="module")
def ref_cli(tmp_path_factory):
    """model -> the reference CLI's (history, printed numbers) at CLI's
    arguments, run once a model in this module."""
    import contextlib
    import io
    d = tmp_path_factory.mktemp("ref_cli")
    runs = {}

    def run(model):
        if model not in runs:
            buf = io.StringIO()
            out = str(d / f"{model}.json")
            with contextlib.redirect_stdout(buf):
                assert ref_train.main(["--model", model, *CLI, "--out",
                                       out]) == 0
            with open(out) as f:
                runs[model] = json.load(f), _printed(buf.getvalue())
        return runs[model]
    return run


def _assert_history(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g["train_loss"] - w["train_loss"]) <= 1e-4, (g, w)
        assert abs(g["test_accuracy"] - w["test_accuracy"]) <= 1e-4, (g, w)


@pytest.mark.parametrize("model", ARCHS + ("deepseek-v2-236b",
                                           "whisper-base"))
def test_lm_cli_prints_the_reference_numbers(model, ref_cli,
                                             tmp_path_factory, capsys):
    """--model <arch> --seq-len 33, 2 rounds of 4 clients: the port's
    losses and holdout evals (-loss) within 1e-4 of the reference CLI's,
    and the printed numbers the reference's to their last digit (a VLM
    trains on text alone, as the reference CLI's batches carry no patch
    embeddings; DeepSeek-V2 with MLA and MoE, its aux in the loss;
    whisper-base as the reference's CLI builds it, a decoder-only stack
    of its widths)."""
    d = tmp_path_factory.mktemp("cli")
    want, want_printed = ref_cli(model)
    assert train.main(["--device", "cpu", "--model", model, *CLI,
                       "--out", str(d / "port.json")]) == 0
    printed = _printed(capsys.readouterr().out)
    with open(d / "port.json") as f:
        _assert_history(json.load(f), want)
    assert len(printed) == len(want_printed) == 2
    for got, exp in zip(printed, want_printed):
        np.testing.assert_allclose(got, exp, rtol=0, atol=1.01e-4)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_lm_checkpoint_resumes_in_the_other_package(direction, ref_cli,
                                                    tmp_path_factory):
    """One package's CLI runs round 0 and saves; the other's resumes the
    checkpoint (the reference's key paths and leaf order: stack[0] with a
    leading groups axis) and runs round 1, within 1e-4 of the reference
    CLI's uninterrupted two rounds."""
    d = tmp_path_factory.mktemp("lm_ckpt")
    want, _ = ref_cli(DENSE)
    ckpt = ["--ckpt-dir", str(d / "ckpt")]
    first, second = ((train.main, ref_train.main)
                     if direction == "port_to_reference"
                     else (ref_train.main, train.main))

    def argv(main, rounds, *extra):
        dev = ["--device", "cpu"] if main is train.main else []
        args = ["--model", DENSE, *CLI, *dev, *ckpt, *extra]
        args[args.index("--rounds") + 1] = str(rounds)
        return args
    assert first(argv(first, 1)) == 0
    assert second(argv(second, 2, "--resume", "--out",
                       str(d / "resumed.json"))) == 0
    with open(d / "resumed.json") as f:
        _assert_history(json.load(f), want)


# ---- the kernels refuse training inputs ----

def _attention_inputs(requires_grad=False):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 2, 8, generator=g, requires_grad=requires_grad)
    k = torch.randn(1, 4, 1, 8, generator=g)
    pos = torch.arange(4)[None]
    return q, k, k.clone(), pos, pos


def _scan_inputs(requires_grad=False):
    g = torch.Generator().manual_seed(0)
    u = torch.randn(1, 3, 4, generator=g, requires_grad=requires_grad)
    dt = torch.rand(1, 3, 4, generator=g)
    b = torch.randn(1, 3, 2, generator=g)
    return (u, dt, b, b.clone(), -torch.rand(4, 2, generator=g),
            torch.ones(4))


def test_kernel_wrappers_refuse_training_inputs():
    """flash_attention and ssm_scan have no backward: an input that
    requires grad, or one inside torch.func's grad or vmap, raises a
    ValueError naming the training route — never a gradient-less
    result. Without grad they run (their plain version on the CPU)."""
    fa_ops.flash_attention(*_attention_inputs())
    ss_ops.ssm_scan(*_scan_inputs())
    with pytest.raises(ValueError, match="loss_fn"):
        fa_ops.flash_attention(*_attention_inputs(requires_grad=True))
    with pytest.raises(ValueError, match="loss_fn"):
        ss_ops.ssm_scan(*_scan_inputs(requires_grad=True))
    q, k, v, qp, kp = _attention_inputs()
    with pytest.raises(ValueError, match="no backward"):
        grad(lambda q: fa_ops.flash_attention(q, k, v, qp, kp).sum())(q)
    u, *rest = _scan_inputs()
    with pytest.raises(ValueError, match="no backward"):
        vmap(lambda u: ss_ops.ssm_scan(u[None], *rest)[0])(u)
    # the training route never reaches them: a loss that asks for the
    # kernel explicitly is refused, the default route trains
    cfg = get_config(DENSE, smoke=True)
    params = port_params(DENSE)
    flat, layout = bridge.load_params(params)
    batch = _torch(lm_batch(DENSE))
    with pytest.raises(ValueError, match="no backward"):
        grad(lambda w: tf.loss_fn(cfg, layout.unflatten(w), batch,
                                  attn_impl="kernel"))(flat)
    assert torch.isfinite(grad(lambda w: tf.loss_fn(
        cfg, layout.unflatten(w), batch))(flat)).all()
