"""repro_torch end to end on the CPU: the trainer against the reference's
FederatedTrainer at quickstart size, the copied host modules against
their originals, the launch driver, and the no-fallback rule for the
device."""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro.core.api import AlgoConfig as RefAlgoConfig
from repro.core.api import ExecConfig as RefExecConfig
from repro.core.api import FederatedTrainer as RefTrainer
from repro.core.baselines import FedDPCHyper as RefFedDPCHyper
from repro.core.samplers import UniformSampler as RefUniformSampler
from repro.data import dirichlet as ref_dirichlet
from repro.data import synthetic as ref_synthetic
from repro.ingest import images as ref_images
from repro.ingest import stack as ref_stack
from repro.models import vision as ref_vision
from repro_torch.configs import paper_lenet5
from repro_torch.core import api
from repro_torch.core.baselines import FedDPCHyper
from repro_torch.core.samplers import UniformSampler
from repro_torch.data import dirichlet, synthetic
from repro_torch.ingest import images, stack
from repro_torch.launch import train
from repro_torch.models import vision

ROUNDS, CLIENTS, COHORT = 3, 30, 10


@functools.lru_cache(maxsize=None)
def _quickstart_data():
    return ref_images.build_federated_image_data(
        num_classes=10, num_clients=CLIENTS, alpha=0.2,
        samples_per_class=100, test_per_class=20, seed=0)


@functools.lru_cache(maxsize=None)
def _ref_init():
    vc = ref_vision.VisionConfig(name="quickstart", family="lenet5",
                                 num_classes=10)
    return jax.tree.map(np.asarray, jax.jit(functools.partial(
        ref_vision.init_vision, vc))(jax.random.PRNGKey(0)))


def _algo_kwargs(name):
    return dict(name=name, eta_l=0.02, eta_g=0.02)


@functools.lru_cache(maxsize=None)
def _reference_run(name):
    """The reference's default (vectorized) round, quickstart sizes."""
    vc = ref_vision.VisionConfig(name="quickstart", family="lenet5",
                                 num_classes=10)
    data = _quickstart_data()
    algo = RefAlgoConfig(hyper=RefFedDPCHyper(lam=1.0)
                         if name == "feddpc" else None, **_algo_kwargs(name))
    with RefTrainer(functools.partial(ref_vision.vision_loss_fn, vc),
                    _ref_init(), CLIENTS,
                    ref_images.StreamingImageSource(data, batch_size=64),
                    RefExecConfig(rounds=ROUNDS, clients_per_round=COHORT,
                                  eval_every=5),
                    algo=algo,
                    sampler=RefUniformSampler(CLIENTS, COHORT)) as tr:
        hist = tr.run()
        return hist, [s.copy() for s in tr.schedule]


@pytest.mark.parametrize("name", ["feddpc", "fedavg"])
@pytest.mark.parametrize("vectorize", [True, False])
def test_trainer_matches_reference_quickstart(name, vectorize):
    ref_hist, ref_schedule = _reference_run(name)
    data = _quickstart_data()
    tr = api.FederatedTrainer(
        functools.partial(vision.vision_loss_fn, paper_lenet5.CONFIG),
        _ref_init(), CLIENTS, images.StreamingImageSource(data, 64),
        api.ExecConfig(rounds=ROUNDS, clients_per_round=COHORT,
                       vectorize=vectorize),
        algo=api.AlgoConfig(hyper=FedDPCHyper(lam=1.0)
                            if name == "feddpc" else None,
                            **_algo_kwargs(name)),
        sampler=UniformSampler(CLIENTS, COHORT), device="cpu")
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


def test_no_device_means_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.FederatedTrainer(lambda p, b: 0.0, {"w": np.zeros(3)}, 4,
                             lambda c, t: [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--rounds", "1", "--clients", "4"])
    assert api.resolve_device("cpu") == torch.device("cpu")
