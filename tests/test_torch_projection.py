"""repro_torch.core.projection / feddpc / baselines on the flat layout,
held against the reference's pytree functions on the same numpy inputs.
(The CPU path: the wrappers run the kernels' plain versions.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro.core import feddpc as ref_feddpc
from repro.core import projection as ref_proj
from repro_torch import bridge
from repro_torch.core import baselines, feddpc, projection
from _torch_threads import one_intra_op_thread  # noqa: F401

K = 5
DIAG_KEYS = ("mean_coef", "mean_cos_angle", "mean_scale", "mean_norm_delta",
             "norm_global_update", "global_dot_prev")


def _trees(round1: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((40, 37), dtype=np.float32),
              "b": rng.standard_normal(37, dtype=np.float32),
              "blocks": [{"c": rng.standard_normal((3, 3, 2, 4),
                                                   dtype=np.float32)}]}
    deltas = jax.tree.map(
        lambda x: rng.standard_normal((K,) + x.shape, dtype=np.float32),
        params)
    prev = jax.tree.map(
        lambda x: (np.zeros_like(x) if round1 else
                   0.3 * x + 0.1 * rng.standard_normal(x.shape,
                                                       dtype=np.float32)),
        params)
    return params, deltas, prev


def _flat(layout, tree):
    return layout.flatten(tree)


def _stack(layout, tree):
    return torch.stack([layout.flatten(jax.tree.map(lambda x: x[j], tree))
                        for j in range(K)])


def _ref_flat(tree):
    return np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree.leaves(tree)])


MASKS = {"none": None, "ragged": np.array([True, False, True, True, False])}


@pytest.mark.parametrize("round1", [True, False])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_server_step_matches_reference(round1, mask, use_kernel):
    params, deltas, prev = _trees(round1)
    cm = MASKS[mask]
    want_p, want_s, want_d = ref_feddpc.server_step(
        {"delta_prev": jax.tree.map(jnp.asarray, prev)},
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, deltas),
        0.1, 0.7, use_kernel=use_kernel,
        client_mask=None if cm is None else jnp.asarray(cm))
    layout = bridge.layout_of(params)
    got_p, got_s, got_d = feddpc.server_step(
        {"delta_prev": _flat(layout, prev)}, _flat(layout, params),
        _stack(layout, deltas), 0.1, 0.7,
        client_mask=None if cm is None else torch.from_numpy(cm))
    # flat sums vs per-leaf sums: f32 summation order only
    np.testing.assert_allclose(got_p.numpy(), _ref_flat(want_p),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_s["delta_prev"].numpy(),
                               _ref_flat(want_s["delta_prev"]),
                               rtol=1e-5, atol=1e-6)
    assert set(got_d) == set(want_d) == set(DIAG_KEYS)
    for key in DIAG_KEYS:
        np.testing.assert_allclose(float(got_d[key]), float(want_d[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    if round1:
        assert float(got_d["mean_coef"]) == 0.0


@pytest.mark.parametrize("round1", [True, False])
def test_projection_functions_match_reference(round1):
    params, deltas, prev = _trees(round1, seed=1)
    layout = bridge.layout_of(params)
    d0 = jax.tree.map(lambda x: x[0], deltas)
    fd, fp = _flat(layout, d0), _flat(layout, prev)
    for got, want in (
            (projection.tree_vdot(fd, fp), ref_proj.tree_vdot(d0, prev)),
            (projection.tree_sqnorm(fd), ref_proj.tree_sqnorm(d0)),
            (projection.tree_norm(fp), ref_proj.tree_norm(prev)),
            (projection.project_coefficient(fd, fp),
             ref_proj.project_coefficient(d0, prev))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-6)
    coef, scale, diag = projection.projection_scalars(
        _stack(layout, deltas), fp, 1.0)
    for j in range(K):
        rc, rs, rd = ref_proj.projection_scalars(
            jax.tree.map(lambda x: x[j], deltas), prev, 1.0)
        np.testing.assert_allclose(float(coef[j]), float(rc), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(float(scale[j]), float(rs), rtol=1e-5)
        for key in rd:
            np.testing.assert_allclose(float(diag[key][j]), float(rd[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("mask", list(MASKS))
def test_masked_client_mean_and_fedavg_match_reference(mask):
    params, deltas, prev = _trees(False, seed=2)
    cm = MASKS[mask]
    layout = bridge.layout_of(params)
    jcm = None if cm is None else jnp.asarray(cm)
    tcm = None if cm is None else torch.from_numpy(cm)
    np.testing.assert_allclose(
        projection.masked_client_mean(_stack(layout, deltas), tcm).numpy(),
        _ref_flat(ref_proj.masked_client_mean(deltas, jcm)),
        rtol=1e-6, atol=1e-6)
    ref_algo = ref_baselines.make_algorithm("fedavg")
    algo = baselines.make_algorithm("fedavg")
    want = ref_algo.step(ref_algo.init(params, 10), params, deltas,
                         jnp.arange(K), 0.3, 0, client_mask=jcm)
    got = algo.step(algo.init(_flat(layout, params), 10),
                    _flat(layout, params), _stack(layout, deltas),
                    torch.arange(K), 0.3, 0, client_mask=tcm)
    np.testing.assert_allclose(got[0].numpy(), _ref_flat(want[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got[2]["norm_global_update"]),
                               float(want[2]["norm_global_update"]),
                               rtol=1e-5)


def test_registry():
    algo = baselines.make_algorithm("feddpc", {"lam": 0.5})
    assert algo.hyper == baselines.FedDPCHyper(lam=0.5)
    assert set(baselines.ALGORITHM_NAMES) == set(
        ref_baselines.ALGORITHM_NAMES)
    with pytest.raises(ValueError, match="unknown algorithm"):
        baselines.make_algorithm("fedsomething")
    with pytest.raises(TypeError, match="FedDPCHyper"):
        baselines.make_algorithm("feddpc", baselines.NoHyper())


def test_tree_nonfinite_count_matches_reference():
    """Per client row, the count of NaN/Inf entries over the flat vector
    equals the reference's over the tree, and the guard kernel's column."""
    params, deltas, _ = _trees(False, seed=4)
    layout = bridge.layout_of(params)
    stack = _stack(layout, deltas)
    stack[1, 3] = float("nan")
    stack[2, :40] = float("inf")
    stack[4] = float("-inf")
    got = projection.tree_nonfinite_count(stack)
    want = np.asarray([ref_proj.tree_nonfinite_count(jax.tree.map(
        lambda x: jnp.asarray(x.numpy()), layout.unflatten(stack[j])))
        for j in range(K)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [0, 1, 40, 0, stack.shape[1]]
    from repro_torch.kernels.feddpc_project import ops
    np.testing.assert_array_equal(ops.feddpc_guard_dots(stack)[:, 3].numpy(),
                                  want)
