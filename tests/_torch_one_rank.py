"""The tensor-parallel route of a family, checked in the test process on a
process group of one gloo rank (``one_rank_group``: the default group on
a HashStore, destroyed after): ``check_tp_route(cfg)`` holds that
``transformer.LMLoss(cfg)`` trains tensor-parallel, that the family's
SMOKE tree splits over 2 model ranks (sharding/layout.tp_classes), and
that ``launch/steps.make_train_step(cfg, model_group=)`` builds and, over
the one rank, steps as the one-process step (the route's collectives
are identities there); a decoder's ``lm_forward`` with the group's
TPContext gives the one-process logits. Imports no JAX.
"""
import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.core import jax_prng
from repro_torch.launch import steps
from repro_torch.models import encdec
from repro_torch.models import transformer as tf
from repro_torch.sharding.layout import ShardLayout, tp_classes
from repro_torch.sharding.tensor_parallel import TPContext

RTOL, ATOL = 1e-5, 1e-6


@contextlib.contextmanager
def one_rank_group():
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _batch(cfg):
    rng = np.random.RandomState(5)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 9)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(rng.randn(
            1, cfg.encoder_seq_len, cfg.d_model).astype(np.float32))
    return batch


def check_tp_route(cfg):
    assert tf.LMLoss(cfg).tensor_parallel
    layout = bridge.layout_of(steps.params_spec(cfg))
    classes = tp_classes(ShardLayout.from_sizes(
        layout, {"clients": 1, "model": 2}), cfg)
    assert "view" in classes
    init = encdec.init_encdec if cfg.is_encoder_decoder else tf.init_lm
    params = init(cfg, jax_prng.PRNGKey(0), torch.float32)
    batch = _batch(cfg)
    want, want_loss = steps.make_train_step(cfg, lr=0.01, remat="none")(
        params, batch)
    with one_rank_group() as group:
        step = steps.make_train_step(cfg, lr=0.01, remat="none",
                                     model_group=group)
        shard, loss = step(layout.flatten(params).clone(), batch)
        if not cfg.is_encoder_decoder:
            tp = TPContext.of(group)
            with torch.no_grad():
                got = tf.lm_forward(cfg, step.view.unflatten(shard),
                                    batch["tokens"], tp=tp)[0]
                ref = tf.lm_forward(cfg, layout.unflatten(shard),
                                    batch["tokens"])[0]
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                                       atol=ATOL)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)
    np.testing.assert_allclose(shard.numpy(),
                               layout.flatten(want).numpy(), rtol=RTOL,
                               atol=ATOL)
