"""repro_torch.core.samplers (a numpy copy of repro.core.samplers): every
sampler draw for draw against the original from one RandomState, with
the same config echo, Markov's shortfall branch and its state round
trip; the training CLI's sampler flags; and the Weighted, Cyclic and
Markov samplers in the trainer against the reference's."""
import json

import numpy as np
import pytest

from _torch_parity import assert_regime_matches
from repro.core import samplers as ref_samplers
from repro_torch.core import samplers
from repro_torch.launch import train
from _torch_threads import one_intra_op_thread  # noqa: F401

ROUNDS = 8


def _same_stream(rng_a, rng_b):
    sa, sb = rng_a.get_state(), rng_b.get_state()
    return sa[2:] == sb[2:] and (sa[1] == sb[1]).all()


def test_sampler_names_match_reference():
    assert set(samplers.sampler_matrix(12, 4)) == set(
        ref_samplers.sampler_matrix(12, 4))


@pytest.mark.parametrize("name", ["uniform", "weighted", "cyclic",
                                  "markov"])
def test_sampler_draws_match_reference(name):
    """8 rounds from one seed: the same cohorts and the same RNG stream
    after each round (the trainer's runtime draws follow the sampler's),
    the same config echo and chain state."""
    mine = samplers.sampler_matrix(30, 10)[name]
    ref = ref_samplers.sampler_matrix(30, 10)[name]
    assert mine.config_dict() == ref.config_dict()
    rng_a, rng_b = np.random.RandomState(7), np.random.RandomState(7)
    for t in range(ROUNDS):
        got, want = mine.sample(rng_a, t), ref.sample(rng_b, t)
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) == 10
        assert _same_stream(rng_a, rng_b), t
        assert mine.state_dict() == ref.state_dict()


def test_markov_shortfall_and_state_round_trip():
    """With p_on small and p_off large most clients are down, so the
    cohort drafts the shortfall (choice + permutation: two draws). A
    state_dict taken after round 3, loaded into a fresh sampler with the
    RNG at the same point, continues the uninterrupted chain exactly."""
    def markov(mod):
        return mod.MarkovSampler(20, 8, p_on=0.1, p_off=0.9)
    mine, ref = markov(samplers), markov(ref_samplers)
    rng_a, rng_b = np.random.RandomState(3), np.random.RandomState(3)
    cohorts, shortfall = [], 0
    for t in range(ROUNDS):
        got = mine.sample(rng_a, t)
        np.testing.assert_array_equal(got, ref.sample(rng_b, t))
        assert _same_stream(rng_a, rng_b)
        cohorts.append(got)
        shortfall += int(mine._avail.sum() < 8)
        if t == 3:
            saved = json.loads(json.dumps(mine.state_dict()))
            assert saved == ref.state_dict()
            rng_saved = rng_a.get_state()
    assert shortfall >= 4
    for mod in (samplers, ref_samplers):
        resumed = markov(mod)
        resumed.load_state_dict(saved)
        rng = np.random.RandomState(0)
        rng.set_state(rng_saved)
        for t in range(4, ROUNDS):
            np.testing.assert_array_equal(resumed.sample(rng, t),
                                          cohorts[t])
    fresh = markov(samplers)
    fresh.load_state_dict({})
    assert fresh.state_dict() == {}


def test_weighted_sampler_config_and_rejections():
    w = np.arange(1, 13, dtype=np.float64)
    mine = samplers.WeightedSampler(w, 4)
    assert mine.config_dict() == ref_samplers.WeightedSampler(
        w, 4).config_dict()
    legacy = {**mine.config_dict()}
    legacy.pop("p_digest"), legacy.pop("p_len")
    legacy["p"] = list(mine.p)
    assert samplers.normalize_sampler_config(legacy) == \
        ref_samplers.normalize_sampler_config(legacy) == mine.config_dict()
    for bad in (np.zeros(5), -np.ones(5), np.array([1.0, 0, 0, 0, 0])):
        with pytest.raises(ValueError):
            samplers.WeightedSampler(bad, 2)


def test_launch_train_sampler_and_server_opt_cpu_smoke(tmp_path):
    """The training CLI with FedVARP, Markov availability and a FedAdam server
    step on the CPU."""
    out = tmp_path / "hist.json"
    rc = train.main(["--model", "lenet5", "--rounds", "2", "--clients", "6",
                     "--participation", "0.5", "--samples-per-class", "20",
                     "--batch-size", "16", "--eval-every", "1",
                     "--algorithm", "fedvarp", "--sampler", "markov",
                     "--server-opt", "fedadam", "--device", "cpu",
                     "--out", str(out)])
    assert rc == 0
    hist = json.loads(out.read_text())
    assert [r["round"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in hist)
    assert set(hist[0]["diagnostics"]) == {"norm_global_update"}


@pytest.mark.parametrize("sampler,name", [("weighted", "fedcm"),
                                          ("cyclic", "fedga"),
                                          ("markov", "fedvarp")])
def test_sampler_in_trainer_matches_reference(sampler, name):
    assert_regime_matches(name, 3, sampler=sampler)
