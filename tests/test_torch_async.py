"""The port's buffered-async regime on the CPU: the runtime models and
the engine against repro.core's (same draws, same arrivals, bitwise),
the async trainer against the reference's FederatedTrainer at quickstart
size, the sync anchor, and in-flight rows that must survive later
waves."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_runs_match, port_trainer, run_reference)
from repro.core import async_engine as ref_engine_mod
from repro.core import runtime as ref_runtime
from repro_torch.core import api
from repro_torch.core import async_engine as engine_mod
from repro_torch.core import runtime
from _torch_threads import one_intra_op_thread  # noqa: F401

ROUNDS = 3
EXP = ("ExponentialRuntime", (("mean", 1.0),))


# ---------------- runtime models ----------------

@pytest.mark.parametrize("name", ["deterministic", "exponential",
                                  "heavytail", "markov"])
def test_runtime_models_draw_the_references_values(name):
    """Same values, and the same number of draws (the trainer's RNG
    stream depends on it), from one RandomState."""
    mine = runtime.runtime_matrix(12)[name]
    ref = ref_runtime.runtime_matrix(12)[name]
    assert mine.config_dict() == ref.config_dict()
    rng_a, rng_b = np.random.RandomState(4), np.random.RandomState(4)
    for wave in range(6):
        clients = np.random.RandomState(wave).choice(12, 5, replace=False)
        (lat, drop), (rlat, rdrop) = (mine.draw(rng_a, wave, clients),
                                      ref.draw(rng_b, wave, clients))
        np.testing.assert_array_equal(lat, rlat)
        np.testing.assert_array_equal(drop, rdrop)
        assert lat.dtype == np.float64 and drop.dtype == bool
        assert mine.state_dict() == ref.state_dict()
    sa, sb = rng_a.get_state(), rng_b.get_state()
    assert sa[2:] == sb[2:] and (sa[1] == sb[1]).all()
    assert runtime.make_runtime(name, 12).config_dict() == \
        ref_runtime.make_runtime(name, 12).config_dict()


# ---------------- the engine, driven by stubs ----------------

class _Staged:
    def __init__(self, wave, clients):
        self.clients = clients
        self.batches, self.masks = wave, None
        self.host_seconds = self.device_seconds = 0.0

    def wait(self):
        pass

    def release(self):
        pass


class _Stager:
    def __init__(self, k, n):
        self.k, self.n = k, n

    def stage_blocking(self, wave):
        return _Staged(wave, np.random.RandomState(wave).choice(
            self.n, self.k, replace=False))


def _drive(make_engine, to_array, stack_type, deadline):
    """Run 6 server rounds of an engine whose wave_update returns row j of
    wave w as [w, j] and whose fold records what it was handed."""
    folds = []
    rng = np.random.RandomState(9)
    lat = {w: ExpDraw(rng) for w in range(400)}

    def wave_update(params, state, wave, masks):
        rows = np.asarray([[wave, j] for j in range(4)], np.float32)
        return to_array(rows), to_array(wave + np.arange(4) / 10.0)

    def fold(state, params, stacked, ids, weights):
        folds.append((np.asarray(stacked), np.asarray(ids),
                      np.asarray(weights)))
        return params + 1, state, {}

    engine = make_engine(pipeline=_Stager(4, 20), wave_update=wave_update,
                         fold=fold, runtime_take=lat.pop, buffer_size=3,
                         alpha=0.7, concurrency=2, deadline=deadline)
    metrics = []
    params = 0
    for t in range(6):
        params, _, m = engine.run_server_round(t, params, None)
        metrics.append({k: v for k, v in m.items() if k != "diag"})
    return folds, metrics


def ExpDraw(rng):
    """One wave's latencies (k = 4) with dropout, as a runtime draws."""
    return (rng.exponential(1.0, 4), rng.rand(4) < 0.2)


@pytest.mark.parametrize("deadline", [None, 0.8])
def test_engine_matches_reference_arrival_for_arrival(deadline):
    ref = _drive(functools.partial(ref_engine_mod.BufferedAsyncEngine,
                                   prefetch=False),
                 jnp.asarray, None, deadline)
    mine = _drive(functools.partial(engine_mod.BufferedAsyncEngine,
                                    prefetch=False),
                  lambda a: torch.from_numpy(np.asarray(a, np.float32)),
                  None, deadline)
    assert len(ref[0]) == len(mine[0]) == 6
    for (d, ids, w), (rd, rids, rw) in zip(mine[0], ref[0]):
        np.testing.assert_array_equal(d, rd)       # which rows, in order
        np.testing.assert_array_equal(ids, rids)
        assert w.dtype == np.float32
        np.testing.assert_array_equal(w, rw)       # staleness weights
    for m, rm in zip(mine[1], ref[1]):
        for key, value in m.items():
            assert value == rm[key], key
    assert any(m["staleness_max"] > 0 for m in mine[1])
    if deadline is not None:
        assert any(m["deadline_fired"] for m in mine[1])


# ---------------- the trainer against the reference ----------------

CASES = {
    # B = 2 arrivals per fold, 3 waves in flight: staleness > 0
    "feddpc_exponential": ("feddpc", dict(async_buffer=True, buffer_size=2,
                                          async_concurrency=3), EXP, False),
    # the anchor: B = K, concurrency 1, deterministic latencies
    "feddpc_anchor": ("feddpc", dict(async_buffer=True), None, False),
    # codec_int8_async, with error feedback and stragglers
    "feddpc_int8_ef_exponential": (
        "feddpc", dict(async_buffer=True, buffer_size=2, async_concurrency=3,
                       codec="int8", codec_ef=True), EXP, True),
    # a rule that is not staleness-aware: deltas pre-scaled by the weights
    "fedavg_exponential": ("fedavg", dict(async_buffer=True, buffer_size=2,
                                          async_concurrency=3), EXP, False),
    # staleness-aware FedDPC-M (its buffer fold at eta_g = 0), and
    # FedVARP's table fed pre-scaled arrivals
    "feddpc_m_exponential": ("feddpc_m", dict(async_buffer=True,
                                              buffer_size=4,
                                              async_concurrency=3), EXP,
                             False),
    "fedvarp_exponential": ("fedvarp", dict(async_buffer=True, buffer_size=4,
                                            async_concurrency=3), EXP, False),
}


@pytest.mark.parametrize("case", CASES)
def test_async_trainer_matches_reference(case):
    name, exec_kw, rt, codec = CASES[case]
    ref_run = run_reference(name, ROUNDS, tuple(exec_kw.items()), rt)
    tr = port_trainer(name, ROUNDS, tuple(exec_kw.items()), rt)
    tr.run()
    assert_runs_match(ref_run, tr, codec=codec)
    if rt is not None:
        assert max(r.staleness_max for r in tr.history) > 0


def test_anchor_equals_the_ports_sync_run():
    """B = K, concurrency 1, deterministic latencies: the same schedule,
    staleness 0, weights 1.0 — the buffered fold is the batched epilogue
    with scales * 1.0, so the parameters agree bitwise."""
    sync = port_trainer("feddpc", ROUNDS)
    anchor = port_trainer("feddpc", ROUNDS, (("async_buffer", True),))
    sync.run()
    anchor.run()
    for a, b in zip(anchor.history, sync.history):
        # the engine averages the arrivals' losses in float64, the sync
        # round in float32 (both as in the reference)
        assert a.train_loss == pytest.approx(b.train_loss, rel=1e-6)
        assert a.staleness_max == 0.0 and a.comm_bytes_up == b.comm_bytes_up
    for a, b in zip(anchor.schedule, sync.schedule):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(anchor.flat, sync.flat)


def test_trainer_validates_the_async_configuration():
    with pytest.raises(ValueError, match="runtime model"):
        port_trainer("feddpc", 1, runtime=EXP)
    with pytest.raises(ValueError, match="vectorize"):
        port_trainer("feddpc", 1, (("async_buffer", True),
                                   ("vectorize", False)))


# ---------------- in-flight rows ----------------

def _linear_trainer(**exec_kw):
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}

    def loss_fn(p, batch):
        return torch.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)

    def batches(c, t):
        r = np.random.RandomState(1000 * c + t)
        return [{"x": r.randn(8, 4).astype(np.float32),
                 "y": r.randn(8, 3).astype(np.float32)}
                for _ in range(c % 3 + 1)]

    return api.FederatedTrainer(
        loss_fn, params, 8, batches,
        api.ExecConfig(rounds=6, clients_per_round=3, seed=7,
                       eval_every=10 ** 9, async_buffer=True, **exec_kw),
        algo=api.AlgoConfig(eta_l=0.05, eta_g=0.1),
        runtime=runtime.ExponentialRuntime(mean=1.0), device="cpu")


@pytest.mark.parametrize("codec", [None, "int8"])
def test_inflight_rows_survive_later_waves(codec):
    """Each wave's deltas are recorded as they leave local training; at
    every fold, every entry still in flight must hold exactly its wave's
    row, although later waves have trained since (a delta stack reused
    across waves would have overwritten it)."""
    tr = _linear_trainer(buffer_size=2, async_concurrency=3, codec=codec)
    engine = tr._engine
    recorded = {}
    wave_update, fold = engine.wave_update, engine.fold

    def recording_wave(params, state, batches, masks):
        deltas, losses = wave_update(params, state, batches, masks)
        recorded[engine.wave_frontier] = {
            key: v.clone() for key, v in (deltas.items() if codec
                                          else [("d", deltas)])}
        return deltas, losses

    checked = []

    def checking_fold(state, params, stacked, ids, weights):
        for _, _, e in engine._heap:
            row = list(tr.schedule[e.wave]).index(e.client)
            want = recorded[e.wave]
            got = e.delta if codec else {"d": e.delta}
            for key in want:
                assert torch.equal(got[key], want[key][row]), (e.wave, key)
            checked.append(e.wave < engine.wave_frontier - 1)
        return fold(state, params, stacked, ids, weights)

    engine.wave_update, engine.fold = recording_wave, checking_fold
    tr.run()
    # some checked entry predates the latest wave's training
    assert any(checked)
