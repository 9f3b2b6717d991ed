"""Shared cases for the repro_torch parity tests (tests/test_torch_*.py):
the reference's initial params, carried across as numpy, and small
seeded inputs that go through both packages."""
import functools

import jax
import numpy as np

from repro.configs import paper_lenet5, paper_resnet18
from repro.models.vision import init_vision

REF_CONFIGS = {"lenet5": paper_lenet5.SMOKE, "resnet18": paper_resnet18.SMOKE}


@functools.lru_cache(maxsize=None)
def ref_params(name: str):
    """The reference's init of a SMOKE config as a numpy tree (one jit,
    cached per process). Callers must not mutate it."""
    cfg = REF_CONFIGS[name]
    params = jax.jit(functools.partial(init_vision, cfg))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def image_batch(rng: np.random.Generator, lead, cfg):
    """{"images": lead + (H, W, C) f32, "labels": lead + int32}."""
    h = cfg.image_size
    return {"images": rng.standard_normal(tuple(lead) + (h, h, cfg.channels),
                                          dtype=np.float32),
            "labels": rng.integers(0, cfg.num_classes, size=lead,
                                   dtype=np.int32)}


# ---- trainer runs at quickstart size (LeNet5, 30 clients, 10 per
# round), through either package ----

QS_CLIENTS, QS_COHORT = 30, 10


@functools.lru_cache(maxsize=None)
def quickstart_data():
    from repro.ingest import images as ref_images
    return ref_images.build_federated_image_data(
        num_classes=10, num_clients=QS_CLIENTS, alpha=0.2,
        samples_per_class=100, test_per_class=20, seed=0)


@functools.lru_cache(maxsize=None)
def quickstart_init():
    """The reference's LeNet5 quickstart init as a numpy tree."""
    from repro.models import vision as ref_vision
    vc = ref_vision.VisionConfig(name="quickstart", family="lenet5",
                                 num_classes=10)
    return jax.tree.map(np.asarray, jax.jit(functools.partial(
        ref_vision.init_vision, vc))(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def run_reference(name, rounds, exec_kw=(), runtime=None, faults=None):
    """The reference's FederatedTrainer with blocking staging (so it draws
    exactly the waves it dispatches, as the port does). ``exec_kw`` is a
    tuple of ExecConfig (key, value) pairs; ``runtime`` is (class name in
    repro.core.runtime, tuple of (key, value) pairs) or None; ``faults``
    a tuple of (key, value) pairs for ``FaultPlan.seeded`` (its seed
    included) or None. Returns (history, schedule, flat params); cached,
    so callers must not mutate them."""
    from repro.core import runtime as ref_runtime
    from repro.core.faults import FaultPlan
    from repro.core.api import AlgoConfig, ExecConfig, FederatedTrainer
    from repro.core.baselines import FedDPCHyper
    from repro.core.samplers import UniformSampler
    from repro.ingest import images as ref_images
    from repro.models import vision as ref_vision
    vc = ref_vision.VisionConfig(name="quickstart", family="lenet5",
                                 num_classes=10)
    rt = (None if runtime is None
          else getattr(ref_runtime, runtime[0])(**dict(runtime[1])))
    with FederatedTrainer(
            functools.partial(ref_vision.vision_loss_fn, vc),
            quickstart_init(), QS_CLIENTS,
            ref_images.StreamingImageSource(quickstart_data(), batch_size=64),
            ExecConfig(rounds=rounds, clients_per_round=QS_COHORT,
                       eval_every=10 ** 9, prefetch=False, **dict(exec_kw)),
            algo=AlgoConfig(name=name, eta_l=0.02, eta_g=0.02,
                            hyper=FedDPCHyper(lam=1.0)
                            if name == "feddpc" else None),
            sampler=UniformSampler(QS_CLIENTS, QS_COHORT),
            runtime=rt, fault_plan=_plan(FaultPlan, faults)) as tr:
        hist = tr.run()
        flat = np.concatenate([np.asarray(x).ravel()
                               for x in jax.tree.leaves(tr.params)])
        return hist, [s.copy() for s in tr.schedule], flat


def _plan(cls, faults):
    if faults is None:
        return None
    kw = dict(faults)
    return cls.seeded(kw.pop("seed"), **kw)


def port_trainer(name, rounds, exec_kw=(), runtime=None, faults=None):
    """The port's FederatedTrainer on the CPU, same data and init."""
    from repro_torch.configs import paper_lenet5
    from repro_torch.core import api
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core import runtime as port_runtime
    from repro_torch.core.baselines import FedDPCHyper
    from repro_torch.core.samplers import UniformSampler
    from repro_torch.ingest import images
    from repro_torch.models import vision
    rt = (None if runtime is None
          else getattr(port_runtime, runtime[0])(**dict(runtime[1])))
    return api.FederatedTrainer(
        functools.partial(vision.vision_loss_fn, paper_lenet5.CONFIG),
        quickstart_init(), QS_CLIENTS,
        images.StreamingImageSource(quickstart_data(), 64),
        api.ExecConfig(rounds=rounds, clients_per_round=QS_COHORT,
                       eval_every=10 ** 9, **dict(exec_kw)),
        algo=api.AlgoConfig(name=name, eta_l=0.02, eta_g=0.02,
                            hyper=FedDPCHyper(lam=1.0)
                            if name == "feddpc" else None),
        sampler=UniformSampler(QS_CLIENTS, QS_COHORT), runtime=rt,
        fault_plan=_plan(FaultPlan, faults), device="cpu")


def assert_runs_match(ref_run, trainer, codec=False):
    """Schedules, staleness, uplink bytes and the chaos counters
    (quarantined, clipped, deadline) equal; losses within 1e-4;
    parameters within 1e-4 (rtol and atol, as the port's client tests).

    With an int8 codec the two packages' local deltas (~1e-6 apart: other
    convolution algorithms) can fall on either side of a rounding
    boundary, and such a code moves its element by one quantization step
    — about 1e-4 in the parameters after the server step. So there the
    parameters hold at 1e-4 except for at most 0.1 % of them, and those
    within 1e-3; the codec itself is held bitwise in test_torch_codec.py.
    """
    ref_hist, ref_schedule, ref_flat = ref_run
    hist = trainer.history
    assert len(trainer.schedule) == len(ref_schedule)
    for got, want in zip(trainer.schedule, ref_schedule):
        np.testing.assert_array_equal(got, want)
    assert len(hist) == len(ref_hist)
    for got, want in zip(hist, ref_hist):
        assert abs(got.train_loss - want.train_loss) <= 1e-4, (got, want)
        assert (got.staleness_mean, got.staleness_max) == \
            (want.staleness_mean, want.staleness_max)
        assert got.comm_bytes_up == want.comm_bytes_up
        for key in ("quarantined", "clipped", "deadline_fired",
                    "deadline_dropped"):
            assert getattr(got, key) == getattr(want, key), (key, got, want)
        assert set(got.diagnostics) == set(want.diagnostics)
    flat = trainer.flat.numpy()
    off = np.abs(flat - ref_flat) > 1e-4 + 1e-4 * np.abs(ref_flat)
    if codec:
        assert off.mean() <= 1e-3, off.sum()
        np.testing.assert_allclose(flat, ref_flat, rtol=0, atol=1e-3)
    else:
        assert not off.any(), np.abs(flat - ref_flat).max()
