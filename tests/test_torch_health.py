"""repro_torch.health: the run-health monitor against repro.health's on
the same record streams (every report field for field, the detector
state after the stream too), and the trainer, sink and JSONL cases of
the reference's tests/test_health.py on the port's trainer."""
import json
import math
import os
from dataclasses import asdict
from types import SimpleNamespace

import numpy as np
import pytest

import _torch_resume_check as rc
from repro.health import monitor as ref_monitor
from repro_torch.core.faults import FaultPlan
from repro_torch.health.monitor import (HealthConfig, HealthMonitor,
                                        JsonlHealthSink)
from _torch_threads import one_intra_op_thread  # noqa: F401

NAN, INF = float("nan"), float("inf")


def rec(t, loss, stale=0.0, quar=0):
    return SimpleNamespace(round=t, train_loss=loss, staleness_mean=stale,
                           quarantined=quar)


def _same(a, b):
    """Equal, NaN equal to NaN (a non-finite loss, an empty window's
    median)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


# (config kwargs, records as (loss, staleness, quarantined)): the
# reference's detector cases, and a stream that trips all four
STREAMS = {
    "spike_unarmed": (dict(min_history=4, spike_mult=3.0),
                      [(1.0, 0, 0), (1.0, 0, 0), (100.0, 0, 0)]),
    "spike_armed": (dict(min_history=4, spike_mult=3.0),
                    [(x, 0, 0) for x in (1.0, 1.1, 0.9, 1.0, 100.0)]),
    "plateau": (dict(window=4, min_history=4, spike_mult=3.0),
                [(x, 0, 0) for x in [1.0] * 4 + [10.0] * 6]),
    "nonfinite": (dict(min_history=4, stop_on_nonfinite=False),
                  [(x, 0, 0) for x in (1.0, NAN, 1.0, INF, 1.0)]),
    "nonfinite_stop": (dict(stop_on_nonfinite=True),
                       [(1.0, 0, 0), (NAN, 0, 0)]),
    "staleness": (dict(min_history=4, staleness_mult=3.0),
                  [(1.0, 1.0, 0)] * 6 + [(1.0, 10.0, 0)]),
    "quarantine": (dict(min_history=4, quarantine_rate=0.25,
                        clients_per_round=4), [(1.0, 0, 2)] * 5),
    "patience": (dict(min_history=2, spike_mult=2.0, patience=2,
                      stop_on_nonfinite=False),
                 [(x, 0, 0) for x in (1.0, 1.0, 5.0, 1.0, 5.0, 5.0)]),
    "mixed": (dict(window=5, min_history=3, patience=3,
                   stop_on_nonfinite=False, clients_per_round=3),
              [(1.0, 0.5, 0), (1.2, 0.4, 1), (0.9, 0.6, 2), (NAN, 0.5, 3),
               (4.0, 3.0, 3), (1.1, 0.5, 2), (6.0, 4.0, 3), (1.0, 0.5, 0),
               (1.0, 0.5, 0), (INF, 0.5, 3), (1.2, 0.6, 1)]),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_monitor_reports_equal_the_references(name):
    cfg_kw, stream = STREAMS[name]
    mine = HealthMonitor(HealthConfig(**cfg_kw))
    ref = ref_monitor.HealthMonitor(ref_monitor.HealthConfig(**cfg_kw))
    assert mine.config.config_dict() == ref.config.config_dict()
    for t, (loss, stale, quar) in enumerate(stream):
        got = asdict(mine.observe(rec(t, loss, stale, quar)))
        want = asdict(ref.observe(rec(t, loss, stale, quar)))
        assert _same(got, want), (t, got, want)
    assert _same(mine.state_dict(), ref.state_dict())
    # the state a checkpoint carries loads into the other package's
    # monitor and the streams continue alike
    again = ref_monitor.HealthMonitor(ref.config)
    again.load_state_dict(mine.state_dict())
    tail = rec(len(stream), 7.0, 9.0, 3)
    assert _same(asdict(again.observe(tail)), asdict(mine.observe(tail)))


def test_state_dict_roundtrip_resumes_mid_window():
    """A fresh monitor loaded from state_dict() at any cut gives the
    uninterrupted monitor's reports on the tail."""
    losses = [1.0, 1.1, 0.9, NAN, 1.0, 5.0, 1.0, 1.2, 6.0, 1.1]
    cfg = HealthConfig(window=4, min_history=3, spike_mult=3.0,
                       patience=3, stop_on_nonfinite=False)
    full = HealthMonitor(cfg)
    full_reports = [full.observe(rec(t, x)) for t, x in enumerate(losses)]
    for cut in (1, 4, 7):
        a = HealthMonitor(cfg)
        for t, x in enumerate(losses[:cut]):
            a.observe(rec(t, x))
        b = HealthMonitor(cfg)
        b.load_state_dict(a.state_dict())
        tail = [b.observe(rec(cut + i, x))
                for i, x in enumerate(losses[cut:])]
        for r_full, r_res in zip(full_reports[cut:], tail):
            assert _same(asdict(r_full), asdict(r_res)), cut
    assert _same(full.state_dict(), b.state_dict())


# ---------------- trainer integration ----------------

def test_trainer_stops_on_injected_nan():
    """An unguarded NaN plan + ExecConfig(health=True): the run stops
    the round the loss goes non-finite instead of training on poison."""
    plan = FaultPlan.seeded(7, nan_rate=1.0, nan_rounds=(2,))
    with rc.port_trainer("feddpc", dict(health=True),
                         fault_plan=plan) as tr:
        recs = tr.run()
    assert len(recs) < 6
    rep = tr.health_report
    assert rep is not None and rep.should_stop
    assert "nonfinite_loss" in rep.alarms
    assert not np.isfinite(recs[-1].train_loss)


def test_trainer_stops_on_loss_spike_with_patience():
    """A finite delta explosion (guard off) trips the spike detector, and
    with patience=1 the run stops on it."""
    plan = FaultPlan.seeded(3, explode_rate=1.0, explode_rounds=(4,),
                            explode_magnitude=200.0)
    with rc.port_trainer("feddpc", dict(rounds=8, health=True,
                                        health_min_history=3,
                                        health_spike_mult=3.0,
                                        health_patience=1),
                         fault_plan=plan) as tr:
        recs = tr.run()
    rep = tr.health_report
    assert rep is not None and rep.should_stop, rep
    assert "loss_spike" in rep.alarms or "nonfinite_loss" in rep.alarms
    assert len(recs) < 8
    assert rep.round == recs[-1].round


def test_healthy_run_is_untouched_and_reports_healthy():
    with rc.port_trainer("feddpc") as tr:
        base = tr.run()
        assert tr.health_report is None         # monitor off by default
    with rc.port_trainer("feddpc", dict(health=True)) as tr:
        recs = tr.run()
        rep = tr.health_report
    assert len(recs) == len(base) == 6
    assert rep is not None and rep.healthy and not rep.should_stop
    assert rep.alarmed_rounds == 0
    # the monitor is a pure observer: the losses are the plain run's
    assert [r.train_loss for r in base] == [r.train_loss for r in recs]


# ---------------- verdict streaming ----------------

class FakeSink:
    """Minimal wandb-style tracker: log(data, step) + close()."""

    def __init__(self, fail_after=None):
        self.rows = []
        self.closed = False
        self.fail_after = fail_after

    def log(self, data, step=None):
        if self.fail_after is not None and len(self.rows) >= self.fail_after:
            raise IOError("tracker down")
        self.rows.append((step, dict(data)))

    def close(self):
        self.closed = True


def _feed(mon, losses):
    return [mon.observe(rec(t, x)) for t, x in enumerate(losses)]


def test_sink_streams_one_flat_row_per_observe():
    sink = FakeSink()
    mon = HealthMonitor(HealthConfig(min_history=2, spike_mult=3.0),
                        sink=sink)
    _feed(mon, [1.0, 1.0, 100.0])
    assert len(sink.rows) == 3
    step, row = sink.rows[-1]
    assert step == 2 and row["round"] == 2
    assert row["alarms"] == "loss_spike" and row["healthy"] is False
    assert sink.rows[0][1]["healthy"] is True
    assert isinstance(row["train_loss"], float)
    mon.close_sink()
    assert sink.closed


def test_failing_sink_disables_with_a_warning_and_the_run_continues():
    sink = FakeSink(fail_after=1)
    mon = HealthMonitor(HealthConfig(), sink=sink)
    with pytest.warns(RuntimeWarning, match="disabled"):
        _feed(mon, [1.0, 1.0, 1.0])
    assert len(sink.rows) == 1
    assert mon._sink is None                 # dropped, not retried
    assert mon.last_report.round == 2        # verdicts kept coming


def test_jsonl_sink_is_lazy_flushed_and_replayable(tmp_path):
    path = str(tmp_path / "health.jsonl")
    sink = JsonlHealthSink(path)
    assert not os.path.exists(path)          # lazy: no log, no file
    mon = HealthMonitor(HealthConfig(min_history=2, spike_mult=3.0),
                        sink=sink)
    _feed(mon, [1.0, 1.0, 100.0])
    # flushed per verdict: readable before close
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    mon.close_sink()
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert rows[0]["healthy"] and rows[1]["healthy"]
    assert rows[2]["alarms"] == "loss_spike" and not rows[2]["healthy"]


def test_trainer_health_log_streams_the_whole_run(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    with rc.port_trainer("feddpc", dict(health=True,
                                        health_log=path)) as tr:
        recs = tr.run()
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    assert [r["step"] for r in rows] == [r.round for r in recs]
    assert all(r["healthy"] for r in rows)


def test_trainer_takes_a_sink_object_and_closes_it():
    sink = FakeSink()
    with rc.port_trainer("feddpc", dict(rounds=3, health=True),
                         health_sink=sink) as tr:
        recs = tr.run()
    assert [s for s, _ in sink.rows] == [r.round for r in recs]
    assert sink.closed                       # context exit released it


def test_sink_config_errors():
    with pytest.raises(ValueError, match="health"):
        rc.port_trainer("feddpc", dict(health_log="x.jsonl"))
    with pytest.raises(ValueError, match="not both"):
        rc.port_trainer("feddpc", dict(health=True, health_log="x.jsonl"),
                        health_sink=FakeSink())
