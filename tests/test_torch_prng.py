"""The port's numpy copy of the reference's PRNG (repro_torch/core/
jax_prng.py) against ``jax.random``: keys, fold_in, split, bits and
uniform bit for bit in both counter layouts, normal within 3 f32 ulp;
the vision init it drives against the reference's ``init_vision``; and
the training CLI printing the reference CLI's numbers at the README's
arguments."""
import functools

import jax
import numpy as np
import pytest

from repro.models import vision as ref_vision
from repro_torch import bridge
from repro_torch.core import jax_prng
from repro_torch.launch import train
from repro_torch.models import vision
from _torch_threads import one_intra_op_thread  # noqa: F401

SHAPES = [(10, 7), (10, 3, 3, 16), (5,), (10, 11), (3,), ()]
SEEDS = [0, 5, 123456, -1]


@pytest.fixture
def partitionable():
    """The counter layout of the installed JAX (the test holds the mode
    it finds; jax_prng's default must be that mode)."""
    mode = bool(jax.config.jax_threefry_partitionable)
    assert jax_prng.PARTITIONABLE == mode
    return mode


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_are_bitwise(seed, partitionable):
    key = jax.random.PRNGKey(seed)
    mine = jax_prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(key), mine)
    for data in (0, 3, 77, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(key, data)),
            jax_prng.fold_in(mine, data))
    np.testing.assert_array_equal(
        jax_prng.fold_in_many(mine, [4, 9]),
        np.stack([jax_prng.fold_in(mine, 4), jax_prng.fold_in(mine, 9)]))
    for num in (2, 3, 5, 10):
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(key, num)),
            jax_prng.split(mine, num))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_are_bitwise(shape, partitionable):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    mine = jax_prng.fold_in(jax_prng.PRNGKey(3), 11)
    np.testing.assert_array_equal(np.asarray(jax.random.bits(key, shape)),
                                  jax_prng.random_bits(mine, shape))
    want = np.asarray(jax.random.uniform(key, shape))
    got = jax_prng.uniform(mine, shape)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_normal_is_within_three_ulp(partitionable):
    """XLA's erf_inv polynomial on numpy's f32 log1p: a few entries land
    one to three ulp from jax's (XLA's own log1p)."""
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.normal(key, (3, 3, 64, 64)))
    got = jax_prng.normal(jax_prng.PRNGKey(3), (3, 3, 64, 64))
    assert got.dtype == np.float32
    assert _ulps(got, want).max() <= 3
    assert (_ulps(got, want) == 0).mean() > 0.9


def test_split_counter_layout_is_bitwise():
    """The older layout (JAX 0.4, the version requirements-dev.txt pins)
    against jax.random with the flag switched for this test."""
    old = bool(jax.config.jax_threefry_partitionable)
    jax.config.update("jax_threefry_partitionable", False)
    try:
        key = jax.random.PRNGKey(7)
        mine = jax_prng.PRNGKey(7)
        for num in (2, 3, 10):
            np.testing.assert_array_equal(
                np.asarray(jax.random.split(key, num)),
                jax_prng.split(mine, num, partitionable=False))
        for shape in ((10, 7), (10, 11), (1,), (3, 3, 5)):
            np.testing.assert_array_equal(
                np.asarray(jax.random.uniform(key, shape)).view(np.uint32),
                jax_prng.uniform(mine, shape,
                                 partitionable=False).view(np.uint32))
        want = np.asarray(jax.random.normal(key, (64, 27)))
        got = jax_prng.normal(mine, (64, 27), partitionable=False)
        assert _ulps(got, want).max() <= 3
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("family,kw", [
    ("lenet5", {}),
    ("resnet18", dict(width=8, num_classes=10)),
])
def test_init_vision_matches_reference(family, kw, partitionable):
    # one jitted program: a few seconds against ~15 eager compiles
    ref = jax.tree.leaves(jax.jit(functools.partial(
        ref_vision.init_vision,
        ref_vision.VisionConfig(name=family, family=family, **kw)))(
            jax.random.PRNGKey(4)))
    mine = bridge.tree_leaves(vision.init_vision(
        vision.VisionConfig(name=family, family=family, **kw),
        jax_prng.PRNGKey(4)))
    assert len(mine) == len(ref)
    for got, want in zip(mine, ref):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_cli_prints_the_reference_numbers(capsys, partitionable):
    """The README's LeNet5 arguments: the reference's CLI prints losses
    2.2307 / 1.9362 and accuracies 0.390 / 0.301."""
    rc = train.main(["--device", "cpu", "--model", "lenet5", "--rounds",
                     "2", "--clients", "6", "--participation", "0.5",
                     "--samples-per-class", "20", "--batch-size", "16",
                     "--eval-every", "1"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "] round" in ln]
    assert lines == ["[feddpc] round    0 loss=2.2307  acc=0.3900",
                     "[feddpc] round    1 loss=1.9362  acc=0.3010"]
