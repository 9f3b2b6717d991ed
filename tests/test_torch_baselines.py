"""repro_torch.core.baselines: every server rule's step against the
reference's on a ragged synthetic layout over three rounds (so Δ_prev,
FedVARP's table and the moments evolve), with and without a client mask;
FedVARP's table, bitwise; the registry's names, hyper classes, defaults
and client knobs."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro_torch import bridge
from repro_torch.core import baselines
from repro_torch.core.round import ID_SENTINEL
from _torch_threads import one_intra_op_thread  # noqa: F401

K, NUM_CLIENTS, ROUNDS, ETA_G = 5, 12, 3, 0.3
RTOL, ATOL = 1e-5, 1e-6
MASKS = {"none": None, "ragged": np.array([True, False, True, True, False])}
RULES = [n for n in ref_baselines.ALGORITHM_NAMES if n != "feddpc"]


def _params(rng):
    return {"w": rng.standard_normal((40, 37), dtype=np.float32),
            "b": rng.standard_normal(37, dtype=np.float32),
            "blocks": [{"c": rng.standard_normal((3, 3, 2, 4),
                                                 dtype=np.float32)}]}


def _rows(tree, n):
    """A reference tree with leading axis n as its (n, N) flat rows."""
    leaves = jax.tree.leaves(tree)
    return np.stack([np.concatenate([np.asarray(x[j]).ravel()
                                     for x in leaves]) for j in range(n)])


def _flat(tree):
    return np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree.leaves(tree)])


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _compare_state(state, ref_state):
    assert set(state) == set(ref_state)
    for key, value in ref_state.items():
        if key == "y":
            _close(state[key].numpy(), _rows(value, NUM_CLIENTS), key)
        elif key == "t":
            assert float(state[key]) == float(value)
        else:
            _close(state[key].numpy(), _flat(value), key)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("name", RULES)
def test_rule_step_matches_reference(name, mask):
    """Three steps from the same params, deltas and ids: new params, Δ_t
    and every state vector within rtol 1e-5, atol 1e-6; the diagnostics
    with the same keys, their values held as FedDPC's are. Masked rows
    carry ID_SENTINEL ids, as the deadline and the guard hand them
    over."""
    rng = np.random.default_rng(0)
    params = _params(rng)
    layout = bridge.layout_of(params)
    cm = MASKS[mask]
    ref_algo = ref_baselines.make_algorithm(name)
    algo = baselines.make_algorithm(name)
    ref_state = ref_algo.init(params, NUM_CLIENTS)
    state = algo.init(layout.flatten(params), NUM_CLIENTS)
    ref_p, p = params, layout.flatten(params)
    for t in range(ROUNDS):
        deltas = jax.tree.map(
            lambda x: rng.standard_normal((K,) + x.shape, dtype=np.float32)
            + 0.5 * x, params)
        ids = rng.choice(NUM_CLIENTS, K, replace=False).astype(np.int32)
        if cm is not None:
            ids[~cm] = ID_SENTINEL
        stack = torch.from_numpy(_rows(deltas, K))
        norm_prev = float(torch.linalg.norm(state["delta_prev"]))
        ref_p, ref_state, ref_diag = ref_algo.step(
            ref_state, ref_p, deltas, jnp.asarray(ids), ETA_G, t,
            client_mask=None if cm is None else jnp.asarray(cm))
        p, state, diag = algo.step(
            state, p, stack, torch.from_numpy(ids), ETA_G, t,
            client_mask=None if cm is None else torch.from_numpy(cm))
        _close(p.numpy(), _flat(ref_p), f"params, round {t}")
        _compare_state(state, ref_state)
        assert set(diag) == set(ref_diag)
        for key, value in ref_diag.items():
            # as FedDPC's own (test_torch_projection.py); <Δ_t, Δ_prev>
            # is ~0 by construction, so it is held to the f32 scale of
            # its terms, ||Δ_t|| ||Δ_prev||
            scale = (norm_prev * float(diag["norm_global_update"])
                     if key == "global_dot_prev" else 1.0)
            np.testing.assert_allclose(float(diag[key]), float(value),
                                       rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=key)


@pytest.mark.parametrize("name", ["feddpc", "feddpc_m"])
def test_staleness_aware_step_matches_reference(name):
    """The buffered-async route of the FedDPC family (the buffer fold's
    plain version here): staleness weights multiply the scales."""
    rng = np.random.default_rng(1)
    params = _params(rng)
    layout = bridge.layout_of(params)
    ref_algo = ref_baselines.make_algorithm(name)
    algo = baselines.make_algorithm(name)
    assert algo.staleness_aware and ref_algo.staleness_aware
    ref_state = ref_algo.init(params, NUM_CLIENTS)
    state = algo.init(layout.flatten(params), NUM_CLIENTS)
    ref_p, p = params, layout.flatten(params)
    for t in range(ROUNDS):
        deltas = jax.tree.map(
            lambda x: rng.standard_normal((K,) + x.shape, dtype=np.float32)
            + 0.5 * x, params)
        wgts = (1.0 + rng.integers(0, 3, K)).astype(np.float32) ** -0.5
        ids = np.arange(K, dtype=np.int32)
        ref_p, ref_state, _ = ref_algo.step(
            ref_state, ref_p, deltas, jnp.asarray(ids), ETA_G, t,
            staleness_weights=jnp.asarray(wgts))
        p, state, _ = algo.step(
            state, p, torch.from_numpy(_rows(deltas, K)),
            torch.from_numpy(ids), ETA_G, t,
            staleness_weights=torch.from_numpy(wgts))
        _close(p.numpy(), _flat(ref_p), f"params, round {t}")
        _compare_state(state, ref_state)


def test_fedvarp_table_rows_bitwise():
    """Counted rows become their deltas bit for bit, in place; rows whose
    id is ID_SENTINEL, out of range (negative or >= num_clients) or whose
    mask bit is clear leave the table bitwise untouched."""
    rng = np.random.default_rng(2)
    n = 53
    algo = baselines.make_algorithm("fedvarp")
    state = algo.init(torch.zeros(n), NUM_CLIENTS)
    state["y"].copy_(torch.from_numpy(
        rng.standard_normal((NUM_CLIENTS, n), dtype=np.float32)))
    before = state["y"].clone()
    deltas = torch.from_numpy(rng.standard_normal((6, n), dtype=np.float32))
    ids = torch.tensor([3, ID_SENTINEL, 7, NUM_CLIENTS, -1, 5],
                       dtype=torch.int32)
    mask = torch.tensor([True, False, True, True, True, False])
    _, new_state, _ = algo.step(state, torch.zeros(n), deltas, ids, ETA_G, 0,
                                client_mask=mask)
    y = new_state["y"]
    assert y is state["y"]
    for row in range(NUM_CLIENTS):
        want = {3: deltas[0], 7: deltas[2]}.get(row, before[row])
        assert torch.equal(y[row], want), row


def test_fedvarp_masked_in_range_row_is_not_written():
    """A masked row with an in-range id: the port leaves its table row
    alone (the mask is the contract), where the reference's scatter,
    which drops only out-of-range ids, writes it. Δ_t is the reference's
    either way, and equal to the step with ID_SENTINEL in that row."""
    rng = np.random.default_rng(3)
    n = 29
    cm = np.array([True, False, True])
    deltas = rng.standard_normal((3, n), dtype=np.float32)
    ref_algo = ref_baselines.make_algorithm("fedvarp")
    _, want, _ = ref_algo.step(
        ref_algo.init({"w": jnp.zeros(n)}, NUM_CLIENTS), {"w": jnp.zeros(n)},
        {"w": jnp.asarray(deltas)}, jnp.asarray([1, 4, 6]), ETA_G, 0,
        client_mask=jnp.asarray(cm))
    out = []
    for ids in ([1, 4, 6], [1, ID_SENTINEL, 6]):
        algo = baselines.make_algorithm("fedvarp")
        state = algo.init(torch.zeros(n), NUM_CLIENTS)
        out.append(algo.step(state, torch.zeros(n), torch.from_numpy(deltas),
                             torch.tensor(ids, dtype=torch.int32), ETA_G, 0,
                             client_mask=torch.from_numpy(cm))[1])
        assert torch.count_nonzero(state["y"][4]) == 0
    assert np.count_nonzero(np.asarray(want["y"]["w"][4])) > 0
    assert torch.equal(out[0]["delta_prev"], out[1]["delta_prev"])
    _close(out[0]["delta_prev"].numpy(), np.asarray(want["delta_prev"]["w"]),
           "delta_t")


def test_registry_hypers_defaults_and_client_knobs():
    assert set(baselines.ALGORITHM_NAMES) == set(
        ref_baselines.ALGORITHM_NAMES)
    for name in ref_baselines.ALGORITHM_NAMES:
        algo, ref = (baselines.make_algorithm(name),
                     ref_baselines.make_algorithm(name))
        assert (algo.name, algo.client_variant, algo.stateful_per_client,
                algo.staleness_aware, algo.client_hparams) == (
            ref.name, ref.client_variant, ref.stateful_per_client,
            ref.staleness_aware, ref.client_hparams), name
        assert baselines.client_kwargs(algo) == ref_baselines.client_kwargs(
            ref)
        assert (algo.client_extra(algo.init(torch.zeros(3), 4)) is None) \
            == (ref.client_extra(ref.init({"w": jnp.zeros(3)}, 4)) is None)
        hcls, rcls = (baselines.algorithm_hyper_cls(name),
                      ref_baselines.algorithm_hyper_cls(name))
        assert hcls.__name__ == rcls.__name__
        ours = {f.name: f.default for f in dataclasses.fields(hcls)}
        theirs = {f.name: f.default for f in dataclasses.fields(rcls)
                  if f.name != "use_kernel"}     # the device decides
        assert ours == theirs, name
        kw = dict(lam=0.5, mu=0.2, cm_alpha=0.3, ga_beta=0.4)
        mine, want = (baselines.default_hyper(name, **kw),
                      ref_baselines.default_hyper(name, **kw))
        assert (mine is None) == (want is None)
        if mine is not None:
            assert dataclasses.asdict(mine) == {
                k: v for k, v in dataclasses.asdict(want).items()
                if k != "use_kernel"}
    assert baselines.FEDVARP.stateful_per_client
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        algo = baselines.get_algorithm("feddpc_m", lam=0.25)
    assert algo.hyper == baselines.FedDPCMHyper(lam=0.25)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    with pytest.raises(TypeError, match="FedProxHyper"):
        baselines.make_algorithm("fedprox", baselines.FedCMHyper())
