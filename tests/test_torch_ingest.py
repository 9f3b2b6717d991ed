"""The port's staged ingest path (repro_torch/ingest) on the CPU: the
prefetch ring (order, backpressure, the stall deadline, supervised
restarts, an owner dropped without close), ``stack_cohort_into`` against
``stack_cohort``, the disk readers and sources on the committed fixtures
byte for byte against the reference's, and the trainer: prefetch on, off
and host-staged bitwise equal, a resume from a save taken with the ring
ahead bitwise the uninterrupted run, ``ingest_crash`` consumed and async
eval; the training CLI's source built from its ExecConfig."""
import argparse
import gc
import os
import threading
import time

import numpy as np
import pytest
import torch

import _torch_resume_check as rc
from repro.ingest import datasets as ref_datasets
from repro.ingest import readers as ref_readers
from repro_torch.core.api import ExecConfig
from repro_torch.core.faults import FaultPlan
from repro_torch.ingest import datasets, readers
from repro_torch.ingest.pipeline import CohortIngestPipeline
from repro_torch.ingest.placement import CohortPlacer
from repro_torch.ingest.prefetch import CohortPrefetcher
from repro_torch.ingest.sources import ListDataSource
from repro_torch.ingest.stack import stack_cohort, stack_cohort_into
from _torch_threads import one_intra_op_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "data")


# ---------------- the prefetch ring ----------------

def test_ring_stages_in_order_and_backpressures():
    """Rounds come out in order; the producer never holds more than
    ``slots`` rounds past the consumer's releases."""
    lock = threading.Lock()
    state = {"produced": 0, "released": 0, "ahead": 0}

    def produce(t, slot):
        with lock:
            state["produced"] += 1
            state["ahead"] = max(state["ahead"],
                                 state["produced"] - state["released"])
        return t * 10

    ring = CohortPrefetcher(produce, 0, 8, slots=2)
    try:
        for t in range(8):
            item, slot = ring.get(t)
            assert item == t * 10
            time.sleep(0.01)          # let the producer run ahead
            with lock:
                state["released"] += 1
            ring.release(slot)
        assert state["ahead"] <= 2
        with pytest.raises(RuntimeError, match="past the configured "
                                               "horizon"):
            ring.get(8)
    finally:
        ring.stop()


def test_ring_raises_on_a_stalled_producer_and_out_of_order_rounds():
    gate = threading.Event()

    def produce(t, slot):
        if t == 1:
            gate.wait(10)
        return t

    ring = CohortPrefetcher(produce, 0, None, slots=2, stall_timeout=0.2)
    try:
        _, slot = ring.get(0)
        ring.release(slot)
        with pytest.raises(RuntimeError, match="stalled: round 1"):
            ring.get(1)
        gate.set()
        with pytest.raises(RuntimeError, match="sequential order"):
            ring.get(5)
    finally:
        gate.set()
        ring.stop()


@pytest.mark.parametrize("budget", [0, 2])
def test_ring_restarts_within_its_budget_then_names_the_cause(budget):
    """Round 2's staging fails twice: a budget of 2 recovers (restarts
    charged to round 2), a budget of 0 makes the next get raise with the
    producer's own error in the message."""
    failures = {2: 2}

    def produce(t, slot):
        if failures.get(t, 0):
            failures[t] -= 1
            raise OSError(f"source read failed at round {t}")
        return t

    ring = CohortPrefetcher(produce, 0, 4, slots=1, max_restarts=budget,
                            restart_backoff=0.001)
    try:
        for t in range(2):
            _, slot = ring.get(t)
            ring.release(slot)
        if budget:
            assert ring.get(2)[0] == 2
            assert ring.restart_count == 2 and ring.restart_rounds == {2: 2}
        else:
            with pytest.raises(RuntimeError, match="source read failed "
                                                   "at round 2"):
                ring.get(2)
    finally:
        ring.stop()


def test_a_dropped_pipeline_ends_its_producer():
    """An open-horizon ring whose owner is dropped without close(): the
    owner is collected and the producer thread ends."""
    src = ListDataSource(lambda c, t: [{"x": np.zeros(2, np.float32)}])
    pipe = CohortIngestPipeline(src, lambda t: np.arange(2), num_clients=4,
                                rounds=None, placer=CohortPlacer("cpu"))
    pipe.get(0).release()
    thread = pipe._ring._thread
    del pipe
    gc.collect()
    thread.join(timeout=5)
    assert not thread.is_alive()


# ---------------- the stacking stage ----------------

def test_stack_cohort_into_equals_stack_cohort():
    rng = np.random.default_rng(0)
    lists = [[{"z": rng.standard_normal((2, 3)).astype(np.float32),
               "a": rng.integers(0, 5, (2,)).astype(np.int32)}
              for _ in range(n)] for n in (2, 0, 3, 1)]
    slot = {}
    for m, pad in ((3, None), (3, 6), (4, 6)):
        want_b, want_m = stack_cohort(lists, m, pad_to=pad)
        got_b, got_m = stack_cohort_into(lists, m, slot, pad_to=pad)
        assert list(got_b) == ["z", "a"]
        for key in want_b:
            np.testing.assert_array_equal(got_b[key].numpy(), want_b[key])
        np.testing.assert_array_equal(got_m.numpy(), want_m)
    again, _ = stack_cohort_into(lists, 4, slot, pad_to=6)
    # the same shape reuses the slot's tensors
    assert again["z"].data_ptr() == got_b["z"].data_ptr()


# ---------------- readers and disk sources ----------------

@pytest.mark.parametrize("name", ["cifar10", "cifar100", "tiny_imagenet"])
def test_readers_match_reference(name):
    mine = getattr(readers, f"load_{name}")(FIXTURES)
    ref = getattr(ref_readers, f"load_{name}")(FIXTURES)
    for field in ("train_labels", "val_labels", "test_labels",
                  "train_images", "test_images"):
        if hasattr(ref, field):
            np.testing.assert_array_equal(getattr(mine, field),
                                          getattr(ref, field))
    if name == "tiny_imagenet":
        assert mine.train_paths == ref.train_paths
        assert mine.val_paths == ref.val_paths
        pool = readers.ImageDecodePool(2)
        np.testing.assert_array_equal(
            np.stack(pool.decode(mine.train_paths[:5], 64)),
            np.stack([ref_readers.decode_image_file(p, 64)
                      for p in ref.train_paths[:5]]))
        pool.close()


@pytest.mark.parametrize("name,augment,workers", [
    ("CIFAR10Source", False, 0), ("CIFAR100Source", True, 0),
    ("TinyImageNetSource", True, 2), ("TinyImageNetSource", False, 0)])
def test_sources_yield_the_references_bytes(name, augment, workers):
    kw = dict(num_clients=4, alpha=0.5, batch_size=8, augment=augment,
              seed=3)
    if name == "TinyImageNetSource":
        kw["decode_workers"] = workers
    mine = getattr(datasets, name)(FIXTURES, **kw)
    ref = getattr(ref_datasets, name)(FIXTURES, **kw)
    assert mine.num_classes == ref.num_classes
    np.testing.assert_array_equal(mine.client_weights(),
                                  ref.client_weights())
    for client in range(4):
        for rnd in (0, 3):
            got = list(mine.client_batches(client, rnd))
            want = list(ref.client_batches(client, rnd))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for key in ("images", "labels"):
                    assert g[key].dtype == w[key].dtype
                    assert g[key].tobytes() == w[key].tobytes()
    for g, w in zip(mine.test_arrays(), ref.test_arrays()):
        assert g.tobytes() == w.tobytes()


# ---------------- the trainer ----------------

REGIMES = {"blocking": dict(prefetch=False),
           "ring": {},
           "host_staged": dict(device_stage=False, prefetch_depth=1),
           "deep": dict(prefetch_depth=4)}


def _run(case, exec_kw, **over):
    with rc.port_trainer(case, exec_kw, **over) as tr:
        tr.run()
        return rc.finals(tr), tr.history


@pytest.mark.parametrize("case", ["feddpc", "async_int8_ef"])
def test_staging_regimes_are_bitwise_equal(case):
    want, want_hist = _run(case, REGIMES["blocking"])
    for regime in ("ring", "host_staged", "deep"):
        got, hist = _run(case, REGIMES[regime])
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{regime} {key}")
        for rec in hist:
            assert rec.ingest_seconds == pytest.approx(
                rec.ingest_host_seconds + rec.ingest_device_seconds)
            assert rec.ingest_host_seconds >= 0.0
            assert rec.ingest_restarts == 0


@pytest.mark.parametrize("case", ["feddpc", "async_int8_ef"])
def test_resume_from_a_save_with_the_ring_ahead(case, tmp_path):
    """A 4-deep ring has sampled rounds past the cut when the save is
    taken; the resumed run is the uninterrupted one bit for bit, and the
    restored history keeps its ingest fields."""
    deep = dict(prefetch_depth=4)
    want, _ = _run(case, deep)
    cut = rc.CASES[case][6]
    part = rc.port_trainer(case, deep)
    with part:
        for t in range(cut):
            part.run_round(t)
        deadline = time.monotonic() + 10
        while (len(part.schedule) <= len(part.state().schedule)
               and time.monotonic() < deadline):
            time.sleep(0.01)      # wait for the ring to sample ahead
        assert len(part.schedule) > len(part.state().schedule)
        part.save(str(tmp_path))
        saved = [r.ingest_host_seconds for r in part.history]
    with rc.port_resume(str(tmp_path), case, deep) as res:
        assert res.start_round == cut
        assert [r.ingest_host_seconds for r in res.history] == saved
        res.run()
        got = rc.finals(res)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("exec_kw", [{}, dict(prefetch=False)],
                         ids=["ring", "blocking"])
def test_ingest_crash_is_consumed(exec_kw):
    """A crash injected into round 1's staging: with a restart budget the
    run recovers (the restart charged to round 1) and repeats the
    fault-free run bit for bit; without one it raises, naming the crash."""
    plan = FaultPlan.seeded(7, ingest_crash_rounds=(1,))
    want, _ = _run("feddpc", exec_kw)
    got, hist = _run("feddpc", dict(exec_kw, ingest_max_restarts=1,
                                    ingest_restart_backoff_s=0.001),
                     fault_plan=plan)
    assert [r.ingest_restarts for r in hist] == [0, 1, 0, 0, 0, 0]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with pytest.raises(RuntimeError, match="injected ingest producer "
                                           "crash at round 1"):
        _run("feddpc", exec_kw, fault_plan=plan)


@pytest.mark.parametrize("dataset", ["synthetic", "tiny-imagenet"])
def test_cli_source_takes_its_settings_from_exec_config(dataset):
    """The training CLI builds its data source from ExecConfig's
    batch_size, local_epochs and decode_workers (args carries none of
    them here, so a read of args would raise)."""
    from repro_torch.launch.train import build_vision_task
    args = argparse.Namespace(model="lenet5", dataset=dataset, num_classes=10,
                              clients=4, alpha=0.5, samples_per_class=4,
                              seed=0, data_root=FIXTURES, augment=False)
    cfg = ExecConfig(batch_size=3, local_epochs=2, decode_workers=2)
    _, _, source, _ = build_vision_task(args, cfg, torch.device("cpu"))
    assert (source.batch_size, source.local_epochs) == (3, 2)
    if dataset == "tiny-imagenet":
        assert source.decoder.workers == 2
        source.decoder.close()
    batches = list(source.client_batches(0, 0))
    assert batches and all(len(b["labels"]) == 3 for b in batches)

def test_async_eval_lands_in_history_and_raises_its_errors():
    """The accuracy of each eval round lands in its record (from a snapshot
    of that round's params); an eval that fails raises at a later round or
    at close(), which still ends the staging thread."""
    def eval_fn(p):
        return float(p["b"].sum())

    with rc.port_trainer("feddpc", dict(eval_every=2, rounds=4),
                         eval_fn=eval_fn) as tr:
        inline = []
        for t in range(4):
            tr.run_round(t)
            if t % 2 == 0 or t == 3:
                inline.append(eval_fn(tr.params))
        tr.finalize()
        assert [r.test_accuracy for r in tr.history
                if r.test_accuracy is not None] == inline

    def broken(p):
        raise ValueError("eval exploded")

    with rc.port_trainer("feddpc", dict(eval_every=1, rounds=3),
                         eval_fn=broken) as tr:
        tr.run_round(0)
        with pytest.raises(ValueError, match="eval exploded"):
            tr.run_round(1)
    tr = rc.port_trainer("feddpc", dict(eval_every=1, rounds=3),
                         eval_fn=broken)
    tr.run_round(0)
    with pytest.raises(ValueError, match="eval exploded"):
        tr.close()
    assert not tr._pipeline._ring._thread.is_alive()
