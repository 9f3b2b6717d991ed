"""repro_torch.models: LeNet5 and ResNet18-GN logits, loss and gradients
from the reference's params carried across, the XLA "SAME" padding at
stride 2, GroupNorm and accuracy — against repro.models on the same
numpy inputs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from _torch_parity import REF_CONFIGS, image_batch, ref_params
from repro.models import layers as ref_layers
from repro.models import vision as ref_vision
from repro_torch import bridge
from repro_torch.configs import paper_lenet5, paper_resnet18
from repro_torch.core import jax_prng
from repro_torch.models import layers, vision
from _torch_threads import one_intra_op_thread  # noqa: F401

PORT_CONFIGS = {"lenet5": paper_lenet5.SMOKE,
                "resnet18": paper_resnet18.SMOKE}


@pytest.mark.parametrize("name", ["lenet5", "resnet18"])
def test_logits_loss_and_grads_match_reference(name):
    rcfg, pcfg = REF_CONFIGS[name], PORT_CONFIGS[name]
    params = ref_params(name)
    batch = image_batch(np.random.default_rng(0), (6,), rcfg)
    flat, layout = bridge.load_params(params)
    tbatch = bridge.to_torch(batch)

    want_logits = jax.jit(functools.partial(ref_vision.vision_forward, rcfg))(
        params, batch["images"])
    got_logits = vision.vision_forward(pcfg, layout.unflatten(flat),
                                       tbatch["images"])
    # f32 convolutions by other algorithms: a few ulps of the logits
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)

    loss_ref = functools.partial(ref_vision.vision_loss_fn, rcfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_ref))(params,
                                                                  batch)

    def flat_loss(w):
        return vision.vision_loss_fn(pcfg, layout.unflatten(w), tbatch)

    np.testing.assert_allclose(float(flat_loss(flat)), float(want_loss),
                               rtol=1e-5, atol=1e-5)
    got_grads = grad(flat_loss)(flat).numpy()
    want = np.concatenate([np.asarray(g).ravel()
                           for g in jax.tree.leaves(want_grads)])
    np.testing.assert_allclose(got_grads, want, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("size,k,stride", [(32, 3, 2), (15, 3, 2),
                                           (16, 1, 2), (8, 3, 1)])
def test_same_padding_matches_xla(size, k, stride):
    """XLA "SAME" pads (0, 1) at stride 2 on an even size — PyTorch's
    symmetric padding=1 would be off by whole rows."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 4), dtype=np.float32)
    w = rng.standard_normal((k, k, 4, 5), dtype=np.float32)
    want = ref_vision._conv(jnp.asarray(x), jnp.asarray(w), stride)
    got = vision._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w), stride).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_group_norm_matches_reference():
    rng = np.random.default_rng(1)
    x = 3.0 + 2.0 * rng.standard_normal((2, 5, 5, 16), dtype=np.float32)
    p = {"scale": rng.standard_normal(16, dtype=np.float32),
         "bias": rng.standard_normal(16, dtype=np.float32)}
    want = ref_layers.group_norm(p, jnp.asarray(x), 4)
    got = layers.group_norm(bridge.to_torch(p),
                            torch.from_numpy(x).permute(0, 3, 1, 2), 4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["lenet5", "resnet18"])
def test_init_and_accuracy(name):
    rcfg, pcfg = REF_CONFIGS[name], PORT_CONFIGS[name]
    params = ref_params(name)
    mine = vision.init_vision(pcfg, jax_prng.PRNGKey(0))
    # the port's own init has the reference's tree and layouts
    assert bridge.layout_of(mine) == bridge.layout_of(params)
    batch = image_batch(np.random.default_rng(2), (32,), rcfg)
    want = jax.jit(functools.partial(ref_vision.vision_accuracy, rcfg))(
        params, batch["images"], batch["labels"])
    got = vision.vision_accuracy(pcfg, bridge.to_torch(params),
                                 *bridge.to_torch([batch["images"],
                                                   batch["labels"]]))
    assert float(got) == pytest.approx(float(want))
