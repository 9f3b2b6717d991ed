"""repro_torch.core.client: the one-client and the vmapped cohort local
updates against the reference's make_local_update /
make_cohort_local_update, with ragged minibatch masks."""
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_parity import REF_CONFIGS, image_batch, ref_params
from repro.core import client as ref_client
from repro.models import vision as ref_vision
from repro_torch import bridge
from repro_torch.configs import paper_lenet5
from repro_torch.core import client
from repro_torch.models import vision

ETA_L = 0.05
MASKS = np.array([[True, True, True],
                  [True, False, False],
                  [True, True, False]])


def _case():
    rcfg = REF_CONFIGS["lenet5"]
    params = ref_params("lenet5")
    k, m = MASKS.shape
    batches = image_batch(np.random.default_rng(3), (k, m, 4), rcfg)
    ref_loss = functools.partial(ref_vision.vision_loss_fn, rcfg)
    port_loss = functools.partial(vision.vision_loss_fn, paper_lenet5.SMOKE)
    return params, batches, ref_loss, port_loss


def _ref_flat_rows(tree, k):
    leaves = jax.tree.leaves(tree)
    return np.stack([np.concatenate([np.asarray(x[j]).ravel()
                                     for x in leaves]) for j in range(k)])


# several SGD steps through f32 convs computed by other algorithms: the
# deltas (scaled by 1/eta_l) agree to ~1e-5 of their size
RTOL, ATOL = 1e-4, 1e-4


@pytest.mark.parametrize("masked", [True, False])
def test_cohort_local_update_matches_reference(masked):
    params, batches, ref_loss, port_loss = _case()
    masks = MASKS if masked else None
    want_d, want_l = jax.jit(ref_client.make_cohort_local_update(
        ref_loss, ETA_L))(params, batches, masks, None)
    flat, layout = bridge.load_params(params)
    local = client.make_cohort_local_update(port_loss, layout, ETA_L)
    out = torch.empty((MASKS.shape[0], layout.size))
    got_d, got_l = local(flat, bridge.to_torch(batches),
                         None if masks is None else torch.from_numpy(masks),
                         out=out)
    assert got_d.data_ptr() == out.data_ptr()
    np.testing.assert_allclose(got_d.numpy(),
                               _ref_flat_rows(want_d, MASKS.shape[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("j", range(MASKS.shape[0]))
def test_serial_local_update_matches_reference_and_cohort(j):
    params, batches, ref_loss, port_loss = _case()
    one = jax.tree.map(lambda x: x[j], batches)
    want_d, want_l = ref_client.make_local_update(ref_loss, ETA_L)(
        params, one, MASKS[j], None)
    flat, layout = bridge.load_params(params)
    got_d, got_l = client.make_local_update(port_loss, layout, ETA_L)(
        flat, bridge.to_torch(one), torch.from_numpy(MASKS[j]))
    want_flat = np.concatenate([np.asarray(x).ravel()
                                for x in jax.tree.leaves(want_d)])
    np.testing.assert_allclose(got_d.numpy(), want_flat, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5,
                               atol=1e-5)
    # the cohort form's row j is this client's update (vmap batches the
    # convolutions into grouped ones: another algorithm, same band)
    cohort_d, cohort_l = client.make_cohort_local_update(
        port_loss, layout, ETA_L)(flat, bridge.to_torch(batches),
                                  torch.from_numpy(MASKS))
    np.testing.assert_allclose(cohort_d[j].numpy(), got_d.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(cohort_l[j]), float(got_l), rtol=1e-6)


def test_fully_masked_client_has_zero_delta():
    params, batches, _, port_loss = _case()
    flat, layout = bridge.load_params(params)
    masks = MASKS.copy()
    masks[1] = False
    d, losses = client.make_cohort_local_update(port_loss, layout, ETA_L)(
        flat, bridge.to_torch(batches), torch.from_numpy(masks))
    assert torch.count_nonzero(d[1]) == 0 and float(losses[1]) == 0.0
    assert torch.count_nonzero(d[0]) > 0


def test_unported_optimizer_raises():
    _, layout = bridge.load_params(ref_params("lenet5"))
    with pytest.raises(ValueError, match="unknown optimizer"):
        client.make_local_update(lambda p, b: 0.0, layout, ETA_L,
                                 optimizer="adamw")
