"""repro_torch.core.client: the one-client and the vmapped cohort local
updates against the reference's make_local_update /
make_cohort_local_update, with ragged minibatch masks — plain SGD, the
prox/cm/ga client variants and the momentum/AdamW local optimizers."""
import functools

import jax
import jax.numpy as jnp
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
                                 optimizer="lamb")
    with pytest.raises(ValueError, match="unknown client variant"):
        client.make_local_update(lambda p, b: 0.0, layout, ETA_L,
                                 variant="scaffold")


# (variant, the variant's knob): each knob off its default so a dropped
# kwarg shows
VARIANTS = {"prox": ("prox", {"mu": 0.5}),
            "cm": ("cm", {"cm_alpha": 0.3}),
            "ga": ("ga", {"ga_beta": 0.7})}


def _extra(params, seed=5):
    """A Δ_{t-1} of the parameters' scale, as a tree and a flat tensor."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda x: 0.5 * rng.standard_normal(x.shape, dtype=np.float32),
        params)
    _, layout = bridge.load_params(params)
    return tree, layout.flatten(tree)


@pytest.mark.parametrize("case", VARIANTS)
def test_cohort_variant_matches_reference(case):
    """The masked cohort update of each variant (FedGA's Δ still against
    the GLOBAL params, the prox term on the (K, N) stack against the
    broadcast global params) against the reference's within 1e-4."""
    variant, kw = VARIANTS[case]
    params, batches, ref_loss, port_loss = _case()
    extra_tree, extra = _extra(params)
    want_d, want_l = jax.jit(ref_client.make_cohort_local_update(
        ref_loss, ETA_L, variant=variant, **kw))(
        params, batches, MASKS, extra_tree)
    flat, layout = bridge.load_params(params)
    got_d, got_l = client.make_cohort_local_update(
        port_loss, layout, ETA_L, variant=variant, **kw)(
        flat, bridge.to_torch(batches), torch.from_numpy(MASKS), extra)
    np.testing.assert_allclose(got_d.numpy(),
                               _ref_flat_rows(want_d, MASKS.shape[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", VARIANTS)
def test_serial_variant_matches_reference(case):
    """The one-client update of a client with valid batches 0 and 1 of
    three (row 2 of MASKS), against the reference's within 1e-4."""
    variant, kw = VARIANTS[case]
    params, batches, ref_loss, port_loss = _case()
    extra_tree, extra = _extra(params)
    one = jax.tree.map(lambda x: x[2], batches)
    want_d, want_l = ref_client.make_local_update(
        ref_loss, ETA_L, variant=variant, **kw)(
        params, one, MASKS[2], extra_tree)
    flat, layout = bridge.load_params(params)
    got_d, got_l = client.make_local_update(
        port_loss, layout, ETA_L, variant=variant, **kw)(
        flat, bridge.to_torch(one), torch.from_numpy(MASKS[2]), extra)
    want_flat = np.concatenate([np.asarray(x).ravel()
                                for x in jax.tree.leaves(want_d)])
    np.testing.assert_allclose(got_d.numpy(), want_flat, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5,
                               atol=1e-5)


def test_ga_fully_masked_client_reports_the_displacement():
    """A FedGA client with no valid batch never moves from its displaced
    start, so its Δ is β·Δ_{t-1} exactly as the reference's: the
    displacement over η_l, against the global params."""
    params, batches, _, port_loss = _case()
    _, extra = _extra(params)
    flat, layout = bridge.load_params(params)
    d, _ = client.make_local_update(port_loss, layout, ETA_L, variant="ga",
                                    ga_beta=0.7)(
        flat, bridge.to_torch(jax.tree.map(lambda x: x[0], batches)),
        torch.zeros(3, dtype=torch.bool), extra)
    want = (flat - (flat - 0.7 * ETA_L * extra)) / ETA_L
    torch.testing.assert_close(d, want, rtol=0, atol=0)



@pytest.mark.parametrize("opt", ["momentum", "adamw"])
def test_local_optimizer_steps_count_masked_batches(opt):
    """The one-client update with a stateful local optimizer equals, bit
    for bit, the optimizer stepped by hand over the client's VALID
    batches with the step index of the batch's position: masked batches
    are no-ops that still advance the counter, as the reference's scan
    counter does (AdamW's bias correction reads it). Each mask puts a
    masked batch before a valid one."""
    from repro_torch.optim import optimizers
    params, batches, _, port_loss = _case()
    flat, layout = bridge.load_params(params)
    update = client.make_local_update(port_loss, layout, ETA_L,
                                      optimizer=opt)
    o = optimizers.get_optimizer(opt, ETA_L)
    grad = torch.func.grad(lambda w, b: port_loss(layout.unflatten(w), b))
    for j, mask in enumerate(([True, False, True], [False, False, True])):
        one = bridge.to_torch(jax.tree.map(lambda x: x[j], batches))
        got, _ = update(flat, one, torch.tensor(mask))
        w = flat.clone()
        state = o.init(w)
        for i, valid in enumerate(mask):
            if valid:
                upd, state = o.update(
                    grad(w, {k: v[i] for k, v in one.items()}), state, w, i)
                w = w - upd
        assert torch.equal(got, (flat - w) / ETA_L), j


# each client has a masked batch before a valid one, so a step counter
# that skipped masked batches would show
GAP_MASKS = np.array([[False, True, True],
                      [True, False, True],
                      [False, False, True]])


def _run_both(ref_loss, port_loss, params, batches, masks, opt, cohort):
    """The reference's and the port's local update with optimizer ``opt``
    on the same inputs: (port deltas, reference deltas), both (K, N)."""
    flat, layout = bridge.load_params(params)
    k = masks.shape[0]
    if cohort:
        want_d, _ = jax.jit(ref_client.make_cohort_local_update(
            ref_loss, ETA_L, optimizer=opt))(params, batches, masks, None)
        got_d, _ = client.make_cohort_local_update(
            port_loss, layout, ETA_L, optimizer=opt)(
            flat, bridge.to_torch(batches), torch.from_numpy(masks))
        return got_d.numpy(), _ref_flat_rows(want_d, k)
    ref_update = ref_client.make_local_update(ref_loss, ETA_L, optimizer=opt)
    port_update = client.make_local_update(port_loss, layout, ETA_L,
                                           optimizer=opt)
    got, want = [], []
    for j in range(k):
        one = jax.tree.map(lambda x: x[j], batches)
        d, _ = ref_update(params, one, masks[j], None)
        want.append(np.concatenate([np.asarray(x).ravel()
                                    for x in jax.tree.leaves(d)]))
        d, _ = port_update(flat, bridge.to_torch(one),
                           torch.from_numpy(masks[j]))
        got.append(d.numpy())
    return np.stack(got), np.stack(want)


@pytest.mark.parametrize("cohort", [True, False])
def test_momentum_local_update_matches_reference(cohort):
    """Local momentum through LeNet5 with masked batches before valid
    ones, cohort and one client at a time, against the reference's
    within 1e-4."""
    params, batches, ref_loss, port_loss = _case()
    got, want = _run_both(ref_loss, port_loss, params, batches, GAP_MASKS,
                          "momentum", cohort)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _quadratic_case():
    """A least-squares linear model: a smooth loss whose gradients are
    far from 0, so AdamW's normalized step is not at the mercy of a
    near-zero gradient's sign (as it is through LeNet5's convolutions)."""
    rng = np.random.default_rng(11)
    d_in, d_out = 6, 3
    params = {"b": rng.standard_normal(d_out, dtype=np.float32),
              "w": rng.standard_normal((d_in, d_out), dtype=np.float32)}
    k, m = GAP_MASKS.shape
    batches = {"x": rng.standard_normal((k, m, 4, d_in), dtype=np.float32),
               "y": rng.standard_normal((k, m, 4, d_out),
                                        dtype=np.float32)}

    def ref_loss(p, b):
        return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    def port_loss(p, b):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    return params, batches, ref_loss, port_loss


@pytest.mark.parametrize("cohort", [True, False])
@pytest.mark.parametrize("opt", ["momentum", "adamw"])
def test_local_optimizer_on_smooth_loss_matches_reference(opt, cohort):
    """Momentum and AdamW on a least-squares loss with masked batches
    before valid ones, against the reference's client update within
    1e-5: AdamW's bias correction reads the step counter, so a masked
    batch that did not advance it as the reference's scan does shows."""
    params, batches, ref_loss, port_loss = _quadratic_case()
    got, want = _run_both(ref_loss, port_loss, params, batches, GAP_MASKS,
                          opt, cohort)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
