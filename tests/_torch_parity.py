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
