"""The port's chaos layer on the CPU against repro.core's: the fault plan
draw for draw (codes, targets, hang boosts, edge drops, ingest crashes,
checkpoint corruption, the config round trip), the update guard's
rolling threshold and state, and the round's fault injection and guard
on stacks with NaN, Inf, exploded and clip-range rows. The trainers
under faults, guard and deadline are held against the reference's in
test_torch_trainer.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_trainer, run_reference
from repro.core import faults as ref_faults
from repro.core import guards as ref_guards
from repro.core import round as ref_round
from repro_torch.core import faults, guards
from repro_torch.core import round as round_mod
from _torch_threads import one_intra_op_thread  # noqa: F401

PLANS = [
    dict(seed=0, nan_rate=0.1, explode_rate=0.1, explode_rounds=(1, 2, 3)),
    dict(seed=7, nan_rate=0.3, hang_rate=0.2, ingest_crash_rate=0.4,
         edge_drop_rate=0.3, explode_magnitude=1e6),
    dict(seed=123, nan_clients=(3, 17), explode_clients=(5,),
         hang_rounds=(0, 2), hang_clients=(1, 4, 9), ingest_crash_rounds=(2,),
         edge_drop_rounds=(1,), edge_drop_edges=(0, 2)),
    dict(seed=2 ** 31 - 5, nan_rate=0.5, explode_rate=0.5, nan_rounds=(4,)),
]


def _both(kw):
    return faults.FaultPlan.seeded(**kw), ref_faults.FaultPlan.seeded(**kw)


@pytest.mark.parametrize("kw", PLANS)
def test_fault_plan_draws_match_reference(kw):
    mine, ref = _both(kw)
    assert mine.active == ref.active
    assert mine.injects_deltas == ref.injects_deltas
    assert mine.injects_edges == ref.injects_edges
    rng = np.random.RandomState(kw["seed"] % 1000)
    for t in range(8):
        sampled = rng.choice(40, 10, replace=False)
        for fn in ("delta_codes", "delta_targets", "latency_boost"):
            got, want = getattr(mine, fn)(t, sampled), \
                getattr(ref, fn)(t, sampled)
            assert got.dtype == want.dtype, fn
            np.testing.assert_array_equal(got, want, err_msg=fn)
        for edges in (1, 4, 8):
            np.testing.assert_array_equal(mine.edge_drops(t, edges),
                                          ref.edge_drops(t, edges))
        for attempt in (0, 1):
            assert mine.ingest_crash(t, attempt) == \
                ref.ingest_crash(t, attempt)
    cfg = mine.config_dict()
    assert cfg == ref.config_dict()
    again = faults.FaultPlan.from_config(cfg)
    assert again == mine and again.config_dict() == cfg
    assert ref_faults.FaultPlan.from_config(cfg).config_dict() == cfg


@pytest.mark.parametrize("mode", ["truncate", "bitflip", "drop_digest"])
def test_checkpoint_corruption_matches_reference(mode, tmp_path):
    """The same checkpoint steps corrupt in the same mode, and
    corrupt_checkpoint damages a checkpoint directory byte for byte as
    the reference's does."""
    inj = dict(rate=0.5, mode=mode)
    mine = faults.FaultPlan(seed=5, injectors=(faults.CkptCorrupt(**inj),))
    ref = ref_faults.FaultPlan(seed=5,
                               injectors=(ref_faults.CkptCorrupt(**inj),))
    modes = [mine.ckpt_corruption(s) for s in range(20)]
    assert modes == [ref.ckpt_corruption(s) for s in range(20)]
    assert mode in modes and None in modes
    assert faults.FaultPlan.from_config(mine.config_dict()) == mine
    payload = bytes(range(256)) * 7
    paths = {}
    for name, fn in (("mine", faults.corrupt_checkpoint),
                     ("ref", ref_faults.corrupt_checkpoint)):
        step = tmp_path / name / "step_00000003"
        step.mkdir(parents=True)
        (step / "state.npz").write_bytes(payload)
        (step / "manifest.json").write_text("{}")
        fn(str(tmp_path / name), 3, mode)
        paths[name] = step
    for fname in ("state.npz", "manifest.json"):
        a, b = paths["mine"] / fname, paths["ref"] / fname
        assert a.exists() == b.exists()
        if a.exists():
            assert a.read_bytes() == b.read_bytes()
    with pytest.raises(ValueError, match="unknown corruption mode"):
        faults.corrupt_checkpoint(str(tmp_path / "mine"), 3, "melt")


def test_update_guard_matches_reference():
    """Threshold after every observation (+inf during the cold start,
    then the window's median), counters and the state round trip, on one
    sequence of norms with NaN and Inf among them."""
    cfg = dict(quarantine_mult=50.0, clip_mult=5.0, window=6, min_history=4)
    mine = guards.UpdateGuard(guards.GuardConfig(**cfg))
    ref = ref_guards.UpdateGuard(ref_guards.GuardConfig(**cfg))
    assert mine.config.config_dict() == ref.config.config_dict()
    rng = np.random.default_rng(1)
    for t in range(9):
        norms = rng.uniform(0.5, 3.0, size=t % 4).astype(np.float32)
        if t == 3:
            norms = np.append(norms, [np.nan, np.inf])
        mine.observe(norms, quarantined=t % 2, clipped=t % 3)
        ref.observe(norms, quarantined=t % 2, clipped=t % 3)
        assert mine.threshold() == ref.threshold(), t
        assert mine.state_dict() == ref.state_dict()
    assert np.isfinite(mine.threshold())
    fresh = guards.UpdateGuard(guards.GuardConfig(**cfg))
    assert fresh.threshold() == float("inf")
    fresh.load_state_dict(ref.state_dict())
    assert fresh.state_dict() == ref.state_dict()
    assert fresh.threshold() == ref.threshold()


def test_apply_fault_codes_matches_reference():
    rng = np.random.default_rng(2)
    d = rng.standard_normal((6, 301), dtype=np.float32)
    codes = np.asarray([0, 1, 2, 0, 2, 1], np.int32)
    got = round_mod.apply_fault_codes(torch.from_numpy(d),
                                      torch.from_numpy(codes), 1e12)
    want = ref_round.apply_fault_codes({"x": jnp.asarray(d)},
                                       jnp.asarray(codes), 1e12)["x"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isnan(got.numpy()[[1, 5]]).all()
    np.testing.assert_array_equal(got.numpy()[[0, 3]], d[[0, 3]])


# a stack for the guard: row 0 clean, 1 one NaN, 2 a -Inf, 3 all NaN,
# 4 exploded (x1e12, finite), 5 in clip range, 6 clean, 7 just below the
# clip limit at thresh = 2
def _guard_stack():
    rng = np.random.default_rng(3)
    n = 777
    d = rng.standard_normal((8, n), dtype=np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)           # unit rows
    d[1, 17] = np.nan
    d[2, 400] = -np.inf
    d[3] = np.nan
    d[4] *= np.float32(1e12)
    d[5] *= np.float32(30.0)
    d[6] *= np.float32(0.5)
    d[7] *= np.float32(19.0)
    return d


@pytest.mark.parametrize("thresh", [float("inf"), 2.0])
@pytest.mark.parametrize("masked", [False, True])
def test_apply_guard_matches_reference(thresh, masked):
    """At thresh = +inf (the cold start) only non-finite rows quarantine
    and nothing clips; at thresh = 2 (clip limit 20, quarantine limit
    2000) the exploded row quarantines and row 5 clips to norm 20.
    ``norm`` is compared on the rows that were not quarantined: there the
    port's norm is the reference's; on a quarantined row the port's is
    taken over the finite entries and the reference's is NaN or inf."""
    d = _guard_stack()
    ids = np.arange(10, 18, dtype=np.int32)
    mask = (np.asarray([1, 1, 1, 1, 1, 1, 0, 1], bool) if masked else None)
    cfg = dict(quarantine_mult=1e3, clip_mult=10.0)
    got = round_mod.apply_guard(
        torch.from_numpy(d), torch.from_numpy(ids),
        None if mask is None else torch.from_numpy(mask), thresh,
        guards.GuardConfig(**cfg))
    want = ref_round.apply_guard(
        {"x": jnp.asarray(d)}, jnp.asarray(ids),
        None if mask is None else jnp.asarray(mask), thresh,
        ref_guards.GuardConfig(**cfg))
    (g_d, g_ids, g_mask, g_st), (w_d, w_ids, w_mask, w_st) = got, want
    q = np.asarray(w_st["quarantined"])
    np.testing.assert_array_equal(g_st["quarantined"].numpy(), q)
    np.testing.assert_array_equal(g_st["clipped"].numpy(),
                                  np.asarray(w_st["clipped"]))
    np.testing.assert_array_equal(g_ids.numpy(), np.asarray(w_ids))
    np.testing.assert_array_equal(g_mask.numpy(), np.asarray(w_mask))
    np.testing.assert_allclose(g_st["norm"].numpy()[~q],
                               np.asarray(w_st["norm"])[~q], rtol=1e-6)
    np.testing.assert_allclose(g_d.numpy(), np.asarray(w_d["x"]),
                               rtol=1e-6, atol=0)
    assert np.isfinite(g_d.numpy()).all()
    expect_q = [1, 2, 3] if thresh == float("inf") else [1, 2, 3, 4]
    assert np.flatnonzero(q).tolist() == expect_q
    assert np.asarray(g_ids)[expect_q].tolist() == \
        [round_mod.ID_SENTINEL] * len(expect_q)
    if thresh == float("inf"):
        assert not g_st["clipped"].any()
        np.testing.assert_array_equal(g_d.numpy()[~q], d[~q])
    else:
        assert np.flatnonzero(g_st["clipped"].numpy()).tolist() == [5]
        assert abs(float(np.linalg.norm(g_d.numpy()[5])) - 20.0) < 1e-4


# ---- the trainer: edge drops without edges, the deadline's validation,
# and the zero-fault guarded run ----

@pytest.mark.parametrize("kw,match", [
    (dict(edge_drop_rounds=(1,)), "item 13"),
])
def test_plans_without_a_consumer_raise(kw, match):
    """A plan with edge drops and no ``edges`` is accepted, as the
    reference accepts it, and its edge drops change nothing: the run is
    the plan's run without them, as in the reference. (The case's id
    keeps the item that brought the consumer.)"""
    del match
    plan = (("nan_rate", 0.1), *((k, tuple(v)) for k, v in kw.items()))
    without = (("nan_rate", 0.1),)
    guard = (("guard", True),)
    ref_hist, _, ref_flat = run_reference("feddpc", 2, guard, faults=(
        ("seed", 0), *plan))
    tr = port_trainer("feddpc", 2, guard, faults=(("seed", 0), *plan))
    base = port_trainer("feddpc", 2, guard, faults=(("seed", 0), *without))
    with tr, base:
        tr.run()
        base.run()
    assert torch.equal(tr.flat, base.flat)
    assert [r.edge_dropped for r in tr.history] == [0, 0]
    assert [r.quarantined for r in tr.history] == \
        [r.quarantined for r in ref_hist]
    np.testing.assert_allclose(tr.flat.numpy(), ref_flat, rtol=1e-4,
                               atol=1e-4)


def test_trainer_validates_the_deadline():
    with pytest.raises(ValueError, match="round_deadline must be positive"):
        port_trainer("feddpc", 1, (("round_deadline", 0.0),))
    # a runtime model with a deadline and no async_buffer is accepted
    tr = port_trainer("feddpc", 1, (("round_deadline", 1.0),),
                      ("ExponentialRuntime", (("mean", 1.0),)))
    assert tr._runtime is not None and tr._engine is None


def test_guarded_zero_fault_run_is_the_unguarded_run():
    """With no faults the guard's threshold starts at +inf and every
    multiplier is exactly 1.0 (and afterwards no clean row comes near the
    limits): the guarded run's parameters and losses are the unguarded
    run's, bitwise."""
    plain = port_trainer("feddpc", 3)
    guarded = port_trainer("feddpc", 3, (("guard", True),))
    plain.run()
    guarded.run()
    assert [r.train_loss for r in guarded.history] == \
        [r.train_loss for r in plain.history]
    assert torch.equal(guarded.flat, plain.flat)
    assert sum(r.quarantined + r.clipped for r in guarded.history) == 0
    assert len(guarded._guard.state_dict()["norms"]) == 30
