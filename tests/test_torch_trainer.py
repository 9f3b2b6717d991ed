"""repro_torch end to end on the CPU: the trainer against the reference's
FederatedTrainer at quickstart size, the copied host modules against
their originals, the launch driver, and the no-fallback rule for the
device."""
import json

import numpy as np
import pytest
import torch

from _torch_parity import assert_runs_match, port_trainer, run_reference
from repro.core.samplers import UniformSampler as RefUniformSampler
from repro.data import dirichlet as ref_dirichlet
from repro.data import synthetic as ref_synthetic
from repro.ingest import images as ref_images
from repro.ingest import stack as ref_stack
from repro_torch.core import api
from repro_torch.core.runtime import ExponentialRuntime
from repro_torch.core.samplers import UniformSampler
from repro_torch.data import dirichlet, synthetic
from repro_torch.ingest import images, stack
from repro_torch.launch import train
from _torch_threads import one_intra_op_thread  # noqa: F401

ROUNDS = 3


@pytest.mark.parametrize("name", ["feddpc", "fedavg"])
@pytest.mark.parametrize("vectorize", [True, False])
def test_trainer_matches_reference_quickstart(name, vectorize):
    ref_hist, ref_schedule, _ = run_reference(name, ROUNDS)
    tr = port_trainer(name, ROUNDS, (("vectorize", vectorize),))
    hist = tr.run()
    # identical client draws, round by round
    assert len(tr.schedule) == ROUNDS
    for got, want in zip(tr.schedule, ref_schedule):
        np.testing.assert_array_equal(got, want)
    # per-round loss within the reference's serial-vs-vectorized band
    for got, want in zip(hist, ref_hist):
        assert abs(got.train_loss - want.train_loss) <= 1e-4, (got, want)
        assert set(got.diagnostics) == set(want.diagnostics)
        for key, value in want.diagnostics.items():
            np.testing.assert_allclose(got.diagnostics[key], value,
                                       rtol=1e-3, atol=1e-4, err_msg=key)


EXP = ("ExponentialRuntime", (("mean", 1.0),))
# NaN rows in rounds 0 and 2, exploded rows in round 1 (after the guard's
# warm-up: round 0 accepts 8 norms, min_history)
FAULTS = (("seed", 0), ("nan_rate", 0.15), ("explode_rate", 0.15),
          ("explode_rounds", (1, 2)))
# (algorithm, ExecConfig pairs, runtime, fault plan, int8 codec?, the
# RoundRecord counters the run must move)
CHAOS = {
    "sync_guard_faults": ("feddpc", (("guard", True),), None, FAULTS, False,
                          ("quarantined",)),
    "sync_deadline_hangs": ("feddpc", (("round_deadline", 1.5),), EXP,
                            (("seed", 1), ("hang_rate", 0.2)), False,
                            ("deadline_dropped",)),
    "serial_guard_clip": ("feddpc", (("guard", True), ("vectorize", False),
                                     ("guard_clip_mult", 1.05)), None,
                          FAULTS, False, ("quarantined", "clipped")),
    # (see the async case below for the short warm-up)
    "sync_int8_ef_guard_deadline": (
        "feddpc", (("guard", True), ("guard_min_history", 4),
                   ("codec", "int8"), ("codec_ef", True),
                   ("round_deadline", 1.5)), EXP, FAULTS, True,
        ("quarantined", "deadline_dropped")),
    # short warm-ups where the deadline (and B = 4) leave round 0 fewer
    # than 8 accepted norms: an explosion folded while the threshold is
    # still +inf goes through, by design, in both packages
    "async_int8_guard_faults_deadline": (
        "feddpc", (("guard", True), ("guard_min_history", 3),
                   ("async_buffer", True), ("buffer_size", 4),
                   ("async_concurrency", 3), ("round_deadline", 0.3),
                   ("codec", "int8"), ("codec_ef", True)), EXP,
        FAULTS + (("hang_rate", 0.1),), True,
        ("quarantined", "deadline_dropped")),
    "fedavg_guard": ("fedavg", (("guard", True),), None, FAULTS, False,
                     ("quarantined",)),
}


@pytest.mark.parametrize("case", CHAOS)
def test_chaos_trainer_matches_reference(case):
    """Fault plan, update guard and round deadline: the same schedules,
    losses within 1e-4, quarantined / clipped / deadline counters and
    uplink bytes equal, parameters as in assert_runs_match."""
    name, exec_kw, rt, plan, codec, moved = CHAOS[case]
    ref_run = run_reference(name, ROUNDS, exec_kw, rt, plan)
    tr = port_trainer(name, ROUNDS, exec_kw, rt, plan)
    tr.run()
    assert_runs_match(ref_run, tr, codec=codec)
    for key in moved:
        assert sum(getattr(r, key) for r in tr.history) > 0, key
    assert np.isfinite(tr.flat.numpy()).all()


def test_copied_host_modules_match_originals():
    labels = np.random.default_rng(0).integers(0, 10, 500)
    for a, b in zip(dirichlet.dirichlet_partition(labels, 12, 0.2, seed=3),
                    ref_dirichlet.dirichlet_partition(labels, 12, 0.2,
                                                      seed=3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(synthetic.make_image_dataset(4, 5, image_size=8, seed=1),
                    ref_synthetic.make_image_dataset(4, 5, image_size=8,
                                                     seed=1)):
        np.testing.assert_array_equal(a, b)
    rng_a, rng_b = np.random.RandomState(5), np.random.RandomState(5)
    mine, ref = UniformSampler(30, 10), RefUniformSampler(30, 10)
    for t in range(4):
        np.testing.assert_array_equal(mine.sample(rng_a, t),
                                      ref.sample(rng_b, t))
    assert mine.config_dict() == ref.config_dict()


def test_image_source_and_stack_match_originals():
    data = images.build_federated_image_data(
        num_classes=4, num_clients=5, alpha=0.3, samples_per_class=12,
        test_per_class=2, image_size=8, seed=2)
    rdata = ref_images.build_federated_image_data(
        num_classes=4, num_clients=5, alpha=0.3, samples_per_class=12,
        test_per_class=2, image_size=8, seed=2)
    src = images.StreamingImageSource(data, batch_size=4)
    rsrc = ref_images.StreamingImageSource(rdata, batch_size=4)
    lists = [list(src.client_batches(c, 1)) for c in range(5)]
    rlists = [list(rsrc.client_batches(c, 1)) for c in range(5)]
    m = max(len(b) for b in lists) + 1
    (b, mask), (rb, rmask) = (stack.stack_cohort(lists, m, pad_to=6),
                              ref_stack.stack_cohort(rlists, m, pad_to=6))
    np.testing.assert_array_equal(mask, rmask)
    for key in ("images", "labels"):
        np.testing.assert_array_equal(b[key], rb[key])
    one, one_mask = stack.stack_batches([], 2, template=lists[0][0])
    assert not one_mask.any() and one["images"].shape[0] == 2


def test_launch_train_cpu_smoke(tmp_path):
    out = tmp_path / "hist.json"
    rc = train.main(["--model", "lenet5", "--rounds", "2", "--clients", "6",
                     "--participation", "0.5", "--samples-per-class", "20",
                     "--batch-size", "16", "--eval-every", "1",
                     "--device", "cpu", "--out", str(out)])
    assert rc == 0
    hist = json.loads(out.read_text())
    assert [r["round"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in hist)
    assert all(r["test_accuracy"] is not None for r in hist)
    assert set(hist[0]["diagnostics"]) >= {"mean_coef", "global_dot_prev"}


def test_launch_train_async_codec_cpu_smoke(tmp_path):
    """The async and codec flags reach the trainer, and the history JSON
    carries staleness and uplink bytes."""
    out = tmp_path / "hist.json"
    rc = train.main(["--model", "lenet5", "--rounds", "3", "--clients", "6",
                     "--participation", "0.5", "--samples-per-class", "20",
                     "--batch-size", "16", "--eval-every", "1",
                     "--async-buffer", "--runtime", "exponential",
                     "--buffer-size", "2", "--async-concurrency", "3",
                     "--codec", "int8", "--codec-ef", "--device", "cpu",
                     "--out", str(out)])
    assert rc == 0
    hist = json.loads(out.read_text())
    assert [r["round"] for r in hist] == [0, 1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in hist)
    assert max(r["staleness_max"] for r in hist) > 0
    # waves of 3 clients ship int8 payloads: N bytes + 8 per leaf each
    per_client = 61_984 + 8 * 8
    assert sum(r["comm_bytes_up"] for r in hist) % per_client == 0
    assert hist[0]["comm_bytes_up"] >= 3 * per_client


def test_launch_train_chaos_cpu_smoke(tmp_path):
    """--guard, --round-deadline and --fault-plan (from a file) reach the
    trainer, and the history JSON carries the chaos counters."""
    plan = tmp_path / "plan.json"
    # every delta of round 0 is NaN, every client of round 2 hangs
    plan.write_text(json.dumps({"seed": 0, "injectors": [
        {"kind": "nan_delta", "rounds": [0], "clients": list(range(6))},
        {"kind": "client_hang", "rounds": [2], "clients": list(range(6))}]}))
    out = tmp_path / "hist.json"
    rc = train.main(["--model", "lenet5", "--rounds", "3", "--clients", "6",
                     "--participation", "0.5", "--samples-per-class", "20",
                     "--batch-size", "16", "--eval-every", "1", "--guard",
                     "--round-deadline", "2.0", "--runtime", "exponential",
                     "--fault-plan", f"@{plan}", "--device", "cpu",
                     "--out", str(out)])
    assert rc == 0
    hist = json.loads(out.read_text())
    assert [r["round"] for r in hist] == [0, 1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in hist)
    assert hist[0]["quarantined"] == 3 - hist[0]["deadline_dropped"] > 0
    assert hist[2]["deadline_dropped"] == 3 and hist[2]["train_loss"] == 0.0
    assert all(r["deadline_fired"] == int(r["deadline_dropped"] > 0)
               for r in hist)


def test_no_device_means_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.FederatedTrainer(lambda p, b: 0.0, {"w": np.zeros(3)}, 4,
                             lambda c, t: [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.FederatedTrainer(lambda p, b: 0.0, {"w": np.zeros(3)}, 4,
                             lambda c, t: [],
                             api.ExecConfig(async_buffer=True, codec="int8"),
                             runtime=ExponentialRuntime())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--rounds", "1", "--clients", "4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--rounds", "1", "--clients", "4", "--async-buffer",
                    "--runtime", "exponential", "--codec", "int8"])
    assert api.resolve_device("cpu") == torch.device("cpu")
