"""The paper's examples on the port (repro_torch/examples) against the
reference's own examples (examples/*.py, loaded as modules and run in
this process), on the CPU: the quickstart and the tiny federated LLM
pretraining at 2 rounds, and one heterogeneity-study cell. Each trainer
either example builds is recorded, and the two packages' histories must
agree within _torch_parity's tolerances (losses within 1e-4; the evals,
accuracies or -holdout losses, within 1e-4). The batched serving example
prints the reference's lines."""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs.base import get_config
from repro_torch.examples import federated_llm_pretraining as llm
from repro_torch.examples import heterogeneity_study as study
from repro_torch.examples import quickstart
from repro_torch.examples import serve_batched
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 2


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)        # its main() is guarded: not run
    return mod


@pytest.fixture
def recording(monkeypatch):
    """record(module) swaps the module's FederatedTrainer for a subclass
    that keeps every trainer it builds; returns the list."""
    def record(module):
        trainers = []
        base = module.FederatedTrainer

        class Recorded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                trainers.append(self)
        monkeypatch.setattr(module, "FederatedTrainer", Recorded)
        return trainers
    return record


def _assert_histories(port_trainers, ref_trainers):
    assert len(port_trainers) == len(ref_trainers) > 0
    for pt, rt in zip(port_trainers, ref_trainers):
        got, want = pt.history, rt.history
        assert len(got) == len(want) == ROUNDS
        for g, w in zip(got, want):
            assert abs(g.train_loss - w.train_loss) <= 1e-4, (g, w)
            assert (g.test_accuracy is None) == (w.test_accuracy is None)
            if w.test_accuracy is not None:
                assert abs(g.test_accuracy - float(w.test_accuracy)) \
                    <= 1e-4, (g, w)


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        out = fn(*args, **kw)
    return out, buf.getvalue()


def test_quickstart_repeats_the_reference(recording):
    """FedAvg then FedDPC on LeNet5, 10 of 30 clients, 2 rounds: the same
    losses and accuracies, and the same printed round lines."""
    ref = _reference_example("quickstart")
    ref_trainers, port_trainers = recording(ref), recording(quickstart)
    _, ref_out = _quiet(ref.main, rounds=ROUNDS)
    hists, out = _quiet(quickstart.main, rounds=ROUNDS, device="cpu")
    _assert_histories(port_trainers, ref_trainers)
    assert list(hists) == ["fedavg", "feddpc"]
    rounds = [ln for ln in out.splitlines() if "] round" in ln]
    assert rounds == [ln for ln in ref_out.splitlines() if "] round" in ln]


def test_llm_pretraining_tiny_repeats_the_reference(recording, monkeypatch,
                                                    tmp_path):
    """--tiny (StarCoder2 SMOKE, 8 clients, 4 a round) at 2 rounds: the
    same losses and holdout NLLs, and the same model and client lines."""
    ref = _reference_example("federated_llm_pretraining")
    ref_trainers, port_trainers = recording(ref), recording(llm)
    monkeypatch.setattr(sys, "argv", ["federated_llm_pretraining.py",
                                      "--tiny", "--rounds", str(ROUNDS),
                                      "--ckpt-dir", str(tmp_path)])
    _, ref_out = _quiet(ref.main)
    hist, out = _quiet(llm.main, ["--tiny", "--rounds", str(ROUNDS),
                                  "--device", "cpu"])
    _assert_histories(port_trainers, ref_trainers)
    assert len(hist) == ROUNDS
    assert out.splitlines()[:2] == ref_out.splitlines()[:2]


def test_heterogeneity_cell_repeats_the_reference(recording, monkeypatch):
    """One cell of the study (alpha 0.1, participation 0.15, FedDPC under
    Markov availability) at 2 rounds: the same TV skew, losses and best
    accuracy."""
    ref = _reference_example("heterogeneity_study")
    ref_trainers, port_trainers = recording(ref), recording(study)
    for mod in (ref, study):
        monkeypatch.setattr(mod, "ROUNDS", ROUNDS)
    want = ref.run_one(0.1, 0.15, "feddpc", sampler="markov")
    got = study.run_one(0.1, 0.15, "feddpc", sampler="markov",
                        device="cpu")
    _assert_histories(port_trainers, ref_trainers)
    assert got[1] == pytest.approx(want[1], abs=1e-12)
    assert abs(got[0] - float(want[0])) <= 1e-4


def _masked(text):
    """The lines with their measured numbers (tok/s, seconds) masked."""
    return [re.sub(r"\d+\.\d+", "#", ln) for ln in text.splitlines()]


def test_serve_batched_prints_the_references_lines(monkeypatch):
    """StarCoder2-3B, Falcon-Mamba-7B and DeepSeek-V2 (MLA + MoE) SMOKE
    served at batch 4, prompt 24, gen 12 through the port's serve_lm on
    the CPU: (4, 12) tokens each, in range, and the reference example's
    lines but for the measured numbers. The reference's lines come from
    its own main() with its serve_lm answering at once (its tokens and
    the port's come from different generators; the serving paths are
    held against each other in test_torch_serve.py and
    test_torch_moe.py)."""
    ref = _reference_example("serve_batched")
    calls = []

    def stub(cfg, batch, prompt_len, gen):
        calls.append((cfg.name, batch, prompt_len, gen))
        return np.zeros((batch, gen), np.int32), {
            "tok_per_s": 1.0, "prefill_s": 1.0}
    monkeypatch.setattr(ref, "serve_lm", stub)
    _, ref_out = _quiet(ref.main)
    out, printed = _quiet(serve_batched.main, ["--device", "cpu"])
    assert list(out) == [name for name, *_ in calls]
    assert calls == [(name, 4, 24, 12) for name in serve_batched.ARCHS]
    for arch, (tokens, stats) in out.items():
        assert tokens.shape == (4, 12) and int(tokens.min()) >= 0
        assert int(tokens.max()) < get_config(arch, smoke=True).vocab_size
        assert stats["tok_per_s"] > 0
    assert _masked(printed) == _masked(ref_out)
