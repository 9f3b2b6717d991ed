"""The port's TrainerState save/resume on the CPU: the state bridge
between its flat buffers and the reference's trees, bitwise resume within
the port (the reference's five resume configs and its four mid-buffer
async cuts; one of them in fresh processes), checkpoints written by one
package and resumed by the other, every restore mismatch error, and the
launch driver's --ckpt-dir / --resume."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_resume_check as rc
from repro.codec import make_codec as ref_make_codec
from repro.core import baselines as ref_baselines
from repro.optim import server as ref_server
from repro_torch import bridge
from repro_torch.codec import make_codec
from repro_torch.core import baselines
from repro_torch.core.runtime import ExponentialRuntime
from repro_torch.core.samplers import MarkovSampler, UniformSampler
from repro_torch.launch import train
from repro_torch.optim import server
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------- the state bridge ----------------

def _tree(seed=0):
    """A params tree with a list and nested dicts (JAX's leaf order is
    sorted keys, lists in order)."""
    r = np.random.RandomState(seed)
    return {"layers": [{"w": r.randn(2, 3).astype(np.float32),
                        "b": r.randn(3).astype(np.float32)},
                       {"w": r.randn(3, 1, 2).astype(np.float32)}],
            "head": r.randn(5).astype(np.float32)}


def _randomize(state, seed):
    """Fill every tensor of a state dict with distinct values (a 0-d
    step count keeps its integral value), so a round trip is bitwise."""
    g = torch.Generator().manual_seed(seed)
    return {k: (v + 3.0 if v.dim() == 0 else
                torch.randn(v.shape, generator=g, dtype=v.dtype))
            for k, v in state.items()}


def _same_structure(got, want):
    """Same tree structure, and each leaf the same shape and dtype."""
    as_np = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, as_np))
    for a, b in zip(bridge.tree_leaves(got), jax.tree.leaves(as_np)):
        a = a.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (a, b)


@pytest.mark.parametrize("name", baselines.ALGORITHM_NAMES)
def test_server_state_maps_to_the_references_init(name):
    """Every rule's flat server state (FedVARP's (C, N) table, the
    adaptive rules' 0-d step count) -> the reference's own init tree in
    structure, shape and dtype, and back bit for bit."""
    params = _tree()
    flat, layout = bridge.load_params(params)
    state = _randomize(baselines.make_algorithm(name).init(flat, 6), 1)
    ref = ref_baselines.make_algorithm(name).init(params, 6)
    mine = bridge.server_state_to_reference(state, layout)
    _same_structure(mine, ref)
    back = bridge.server_state_from_reference(bridge.to_numpy(mine), layout)
    assert set(back) == set(state)
    for k in state:
        assert back[k].dtype == state[k].dtype
        assert torch.equal(back[k], state[k]), k


def test_table_leaves_are_views_of_the_table():
    params = _tree()
    flat, layout = bridge.load_params(params)
    state = baselines.make_algorithm("fedvarp").init(flat, 4)
    tree = bridge.server_state_to_reference(state, layout)
    tree["y"]["layers"][1]["w"][2].fill_(7.0)
    off = layout.paths.index(("layers", 1, "w"))
    start = int(layout.leaf_offsets[off])
    assert (state["y"][2, start:start + 6] == 7.0).all()
    assert int((state["y"] != 0).sum()) == 6


@pytest.mark.parametrize("name", ["fedadam", "fedyogi"])
def test_server_optimizer_moments_map_to_the_references_init(name):
    params = _tree()
    flat, layout = bridge.load_params(params)
    moments = _randomize(server.make_server_optimizer(name).init(flat), 2)
    mine = bridge.server_state_to_reference(moments, layout)
    _same_structure(mine, ref_server.make_server_optimizer(name).init(params))
    back = bridge.server_state_from_reference(bridge.to_numpy(mine), layout)
    for k in moments:
        assert torch.equal(back[k], moments[k])


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_entry_payload_maps_to_the_references_bitwise(codec):
    """One async entry's payload {"q": (N,), "scale": (L,), "zero": (L,)}
    -> the reference codec's single-client payload (per-leaf codes in
    their dtype, a scalar scale and zero per leaf), bit for bit, and
    back."""
    params = _tree()
    deltas = [_tree(seed) for seed in (3, 4)]
    flat, layout = bridge.load_params(params)
    stack = torch.stack([layout.flatten(d) for d in deltas])
    payload = make_codec(codec).encode_cohort(stack, layout.leaf_offsets)
    ref_codec = ref_make_codec(codec)
    for j, d in enumerate(deltas):
        row = {k: v[j] for k, v in payload.items()}
        mine = bridge.payload_to_reference(row, layout)
        want = jax.tree.map(np.asarray, ref_codec.encode(d))
        assert jax.tree.structure(jax.tree.map(lambda x: 0, mine)) == \
            jax.tree.structure(jax.tree.map(lambda x: 0, want))
        for a, b in zip(bridge.tree_leaves(mine), jax.tree.leaves(want)):
            if a.dtype == torch.bfloat16:
                a = a.view(torch.int16).numpy()
                b = b.view(np.int16)
            else:
                a = a.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        back = bridge.payload_from_reference(mine, layout)
        for k in row:
            assert back[k].dtype == row[k].dtype
            assert torch.equal(back[k], row[k]), k


# ---------------- bitwise resume within the port ----------------

def _assert_finals_equal(full, res):
    assert set(full) == set(res)
    for k in full:
        np.testing.assert_array_equal(full[k], res[k], err_msg=k)


IN_PROCESS = [c for c in rc.CASES if c not in ("feddpc_fedadam",
                                               "fedvarp_fedadam")]


@pytest.mark.parametrize("case", IN_PROCESS)
def test_resume_is_bitwise_the_uninterrupted_run(case, tmp_path):
    """Save at the cut, resume in a fresh trainer: params, server state,
    moments, EF, guard window, schedule and losses equal the
    uninterrupted run's bit for bit (an async cut with entries in
    flight)."""
    cut = rc.CASES[case][6]
    with rc.port_trainer(case) as full:
        full.run()
    part = rc.run_cut(rc.port_trainer(case), cut, str(tmp_path))
    if part._engine is not None:
        assert len(part._engine.inflight()) > 0      # mid-buffer cut
    with rc.port_resume(str(tmp_path), case) as res:
        assert res.start_round == cut
        res.run()
    _assert_finals_equal(rc.finals(full), rc.finals(res))
    assert [(r.staleness_mean, r.staleness_max) for r in full.history] == \
        [(r.staleness_mean, r.staleness_max) for r in res.history]
    # as of the consumed frontier: the staging ring samples ahead
    assert res.state().sampler_state == full.state().sampler_state


def test_resume_in_fresh_processes_is_bitwise(tmp_path):
    """The crash-and-requeue case: FedDPC under a FedAdam server step
    with the health monitor on, each phase a fresh interpreter."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
         env.get("PYTHONPATH", "")])
    for phase in ("full", "part", "resume"):
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "_torch_resume_check.py"),
             phase, str(tmp_path), "feddpc_fedadam"],
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert f"PHASE {phase} OK" in proc.stdout
    full = np.load(tmp_path / "full.npz")
    res = np.load(tmp_path / "resume.npz")
    assert "opt/m" in full.files and "health_loss_window" in full.files
    _assert_finals_equal(dict(full), dict(res))


def test_save_rolls_back_to_the_wave_frontier():
    """Async waves run ahead of the server rounds: the saved RNG is the
    one before the frontier wave was drawn, and a capture taken at
    sampling time is what state() hands back. Blocking staging, so the
    RNG stands at the frontier until the test samples ahead itself (the
    ring's own look-ahead: test_torch_ingest.py)."""
    tr = rc.port_trainer("async_markov", dict(prefetch=False))
    for t in range(3):
        tr.run_round(t)
    eng = tr._engine
    assert eng.wave_frontier > len(tr.history)
    st = tr.state()
    assert len(st.schedule) == eng.wave_frontier
    live = tr.rng.get_state()
    assert (st.rng_state[1] == live[1]).all() and st.rng_state[2] == live[2]
    # a wave sampled ahead of the frontier: state() rolls back to its
    # capture, and the schedule drops it
    cap = tr._capture()
    tr._sample_clients(eng.wave_frontier)
    st = tr.state()
    assert st.rng_state[2] == cap["rng"][2]
    assert (st.rng_state[1] == cap["rng"][1]).all()
    assert len(st.schedule) == eng.wave_frontier


# ---------------- across packages ----------------

def _ref_flat(tr):
    return np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree.leaves(tr.params)])


def _assert_matches_reference(hist, schedule, flat, sampler_state,
                              ref_full, codec):
    """_torch_parity.assert_runs_match's tolerances: schedules and the
    counters exact, losses within 1e-4, params within 1e-4 (with an
    int8 codec at most 0.1 % of them past it, all within 1e-3)."""
    want_hist = ref_full.history
    assert len(schedule) == len(ref_full.schedule)
    for got, want in zip(schedule, ref_full.schedule):
        np.testing.assert_array_equal(got, want)
    assert sampler_state == ref_full.sampler.state_dict()
    assert len(hist) == len(want_hist)
    for got, want in zip(hist, want_hist):
        assert got.round == want.round
        assert abs(got.train_loss - want.train_loss) <= 1e-4, (got, want)
        for key in ("staleness_mean", "staleness_max", "comm_bytes_up",
                    "quarantined", "clipped", "deadline_fired",
                    "deadline_dropped"):
            assert getattr(got, key) == getattr(want, key), (key, got, want)
    ref_flat = _ref_flat(ref_full)
    off = np.abs(flat - ref_flat) > 1e-4 + 1e-4 * np.abs(ref_flat)
    if codec:
        assert off.mean() <= 1e-3, off.sum()
        np.testing.assert_allclose(flat, ref_flat, rtol=0, atol=1e-3)
    else:
        assert not off.any(), np.abs(flat - ref_flat).max()


CROSS = ["feddpc", "fedvarp_fedadam", "async_int8_ef"]
_REF_FULL = {}


def _ref_full(case):
    if case not in _REF_FULL:
        with rc.ref_trainer(case) as tr:
            tr.run()
        _REF_FULL[case] = tr
    return _REF_FULL[case]


@pytest.mark.parametrize("case", CROSS)
def test_reference_checkpoint_resumes_in_the_port(case, tmp_path):
    """The reference saves at the cut (with an 8-deep prefetch ring, so
    its RNG and sampler roll back past staged rounds), the port resumes
    and runs to the end: within the trainer tolerances of the
    reference's uninterrupted run, the same schedule."""
    cut = rc.CASES[case][6]
    rc.run_cut(rc.ref_trainer(case, dict(prefetch=True, prefetch_depth=8)),
               cut, str(tmp_path))
    with rc.port_resume(str(tmp_path), case) as tr:
        assert tr.start_round == cut
        if tr._engine is not None:
            assert len(tr._engine.inflight()) > 0
        tr.run()
        # the consumed frontier: the port's ring samples waves ahead, the
        # reference's uninterrupted run stages them blocking
        st = tr.state()
    _assert_matches_reference(tr.history, st.schedule, tr.flat.numpy(),
                              st.sampler_state, _ref_full(case),
                              codec=case == "async_int8_ef")


@pytest.mark.parametrize("case", CROSS)
def test_port_checkpoint_resumes_in_the_reference(case, tmp_path):
    cut = rc.CASES[case][6]
    part = rc.run_cut(rc.port_trainer(case), cut, str(tmp_path))
    if part._engine is not None:
        assert len(part._engine.inflight()) > 0
    with rc.ref_resume(str(tmp_path), case) as tr:
        assert tr.start_round == cut
        tr.run()
    _assert_matches_reference(tr.history, tr.schedule, _ref_flat(tr),
                              tr.sampler.state_dict(), _ref_full(case),
                              codec=case == "async_int8_ef")


# ---------------- restore mismatches ----------------

MISMATCH = {
    # case saved, exec overrides and trainer kwargs of the resume, match
    "algorithm": ("feddpc", {}, dict(algo_name="fedavg"), "feddpc"),
    "num_clients": ("feddpc", {}, dict(num_clients=9), "num_clients"),
    "hyper": ("feddpc", {}, dict(hyper={"lam": 2.0}), "algo_config"),
    "sampler_class": ("feddpc", {}, dict(sampler=UniformSampler(8, 3)),
                      "MarkovSampler"),
    "clients_per_round": ("feddpc", dict(clients_per_round=4),
                          dict(sampler=MarkovSampler(8, 4, p_on=0.6,
                                                     p_off=0.4)),
                          "clients_per_round"),
    "sampler_config": ("feddpc", {}, dict(sampler=MarkovSampler(
        8, 3, p_on=0.5, p_off=0.4)), "sampler"),
    "async_buffer_size": ("async_markov", dict(buffer_size=3), {},
                          "buffer_size"),
    "async_runtime": ("async_markov", {},
                      dict(runtime=ExponentialRuntime()), "runtime"),
    "async_into_sync": ("async_markov", dict(async_buffer=False), {},
                        "buffered-async"),
    "codec_bf16": ("async_int8_ef", dict(codec="bf16"), {}, "codec"),
    "codec_no_ef": ("async_int8_ef", dict(codec_ef=False), {}, "codec"),
    "codec_none": ("async_int8_ef", dict(codec=None, codec_ef=None), {},
                   "codec"),
    "server_opt_other": ("feddpc_fedadam", dict(server_opt="fedyogi"), {},
                         "server optimizer"),
    "server_opt_none": ("feddpc_fedadam", dict(server_opt="sgd"), {},
                        "server optimizer"),
    "health_off": ("feddpc_fedadam", dict(health=False), {}, "health"),
    "health_config": ("feddpc_fedadam", dict(health_window=5), {},
                      "health"),
    "chaos_plan": ("feddpc_guarded", {}, dict(fault_plan=None), "chaos"),
    "chaos_guard": ("feddpc_guarded", dict(guard_min_history=2), {},
                    "chaos"),
    "chaos_missing": ("feddpc", dict(guard=True), {}, "chaos"),
}
_SAVED = {}


def _saved(case, tmp_path_factory):
    if case not in _SAVED:
        d = str(tmp_path_factory.mktemp(f"saved_{case}"))
        rc.run_cut(rc.port_trainer(case), 1, d)
        _SAVED[case] = d
    return _SAVED[case]


@pytest.mark.parametrize("what", sorted(MISMATCH))
def test_restore_rejects_a_mismatched_configuration(what, tmp_path_factory):
    """A checkpoint echoes everything that parameterizes the run; a
    resume under any other value fails loudly, as the reference's
    (test_async.py, test_codec.py, test_optim.py, test_health.py,
    test_api_surface.py)."""
    case, exec_kw, over, match = MISMATCH[what]
    d = _saved(case, tmp_path_factory)
    cfg, kw = rc._args(case, "port", exec_kw)
    if "algo_name" in over or "hyper" in over:
        kw["algo"] = type(kw["algo"])(
            name=over.pop("algo_name", kw["algo"].name), eta_l=0.05,
            eta_g=0.1, hyper=over.pop("hyper", None))
    num_clients = over.pop("num_clients", rc.NUM_CLIENTS)
    kw.update(over)
    from repro_torch.core.api import FederatedTrainer
    with pytest.raises(ValueError, match=match):
        FederatedTrainer.resume(d, rc.port_loss, rc.make_params(),
                                num_clients, rc.ragged_batch_fn, cfg,
                                device="cpu", **kw)


def test_restore_needs_a_fresh_trainer(tmp_path):
    d = str(tmp_path)
    tr = rc.run_cut(rc.port_trainer("feddpc"), 1, d)
    with pytest.raises(RuntimeError, match="freshly constructed"):
        tr.restore(d)


# ---------------- the launch driver ----------------

def test_cli_checkpoints_every_round_and_resumes(tmp_path, capsys):
    ckpt_dir = str(tmp_path / "ck")
    base = ["--device", "cpu", "--model", "lenet5", "--clients", "4",
            "--participation", "0.5", "--samples-per-class", "8",
            "--batch-size", "16", "--eval-every", "100",
            "--ckpt-dir", ckpt_dir, "--health"]
    assert train.main(base + ["--rounds", "2", "--ckpt-every", "1",
                              "--out", str(tmp_path / "a.json")]) == 0
    steps = sorted(os.listdir(ckpt_dir))
    assert steps == ["step_00000001", "step_00000002"], steps
    assert train.main(base + ["--rounds", "3", "--resume",
                              "--out", str(tmp_path / "b.json")]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {ckpt_dir} at round 2" in out
    assert "health: 0 alarmed rounds" in out
    hist = json.load(open(tmp_path / "b.json"))
    first = json.load(open(tmp_path / "a.json"))
    assert [r["round"] for r in hist] == [0, 1, 2]
    assert [r["train_loss"] for r in hist[:2]] == \
        [r["train_loss"] for r in first]
    assert "step_00000003" in os.listdir(ckpt_dir)
