"""int8_sr in the port against the reference on the CPU: the codes of the
plain version of its kernel (kernels/int8_sr/ref.py) bit for bit equal
to the reference's ``encode_cohort`` on a multi-leaf tree with 4-D leaves
and a NaN row, in either counter layout of the PRNG; a synchronous round
and buffered-async waves with int8_sr and error feedback against the
reference trainer; and the codec's unbiasedness. The kernel itself is
held bit for bit against ref.py on the card (tests/test_torch_cuda.py,
which imports no JAX)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import make_codec as ref_make_codec
from repro_torch.bridge import layout_of
from repro_torch.codec import make_codec
from repro_torch.core import jax_prng
from repro_torch.kernels.int8_sr import ops as sr_ops
from repro_torch.kernels.int8_sr import ref as sr_ref
from _torch_threads import one_intra_op_thread  # noqa: F401

K = 4
EXP = ("ExponentialRuntime", (("mean", 1.0),))


def _tree(seed=0):
    """Client-stacked leaves, 4-D convolutions among them (a ragged
    count, so the split-counter layout pads); row 1 holds a NaN, row 2 is
    all zeros in 'b' (a unit scale)."""
    rng = np.random.default_rng(seed)
    tree = {"conv": rng.standard_normal((K, 3, 3, 4, 5)).astype(np.float32),
            "proj": (rng.standard_normal((K, 1, 1, 3, 7)) * 1e-3
                     ).astype(np.float32),
            "b": rng.standard_normal((K, 9)).astype(np.float32),
            "w": rng.standard_normal((K, 11, 6)).astype(np.float32)}
    tree["conv"][1, 2, 0, 3, 1] = np.nan
    tree["b"][2] = 0.0
    return tree


def _flat(tree):
    """(K, N) stack in the port's layout (leaves in sorted key order)."""
    one = {k: v[0] for k, v in tree.items()}
    return (torch.from_numpy(np.concatenate(
        [tree[k].reshape(K, -1) for k in sorted(tree)], axis=1)),
        layout_of(one).leaf_offsets)


def _ref_codes(tree, key):
    payload = ref_make_codec("int8_sr").encode_cohort(
        {k: jnp.asarray(v) for k, v in tree.items()}, key=key)
    keys = sorted(payload["q"])
    return (np.concatenate([np.asarray(payload["q"][k]).reshape(K, -1)
                            for k in keys], 1),
            np.stack([np.asarray(payload["scale"][k]) for k in keys], 1))


def test_codes_match_reference_bitwise():
    tree = _tree()
    flat, offsets = _flat(tree)
    want_q, want_s = _ref_codes(tree, jax.random.fold_in(
        jax.random.PRNGKey(5), 3))
    got = make_codec("int8_sr").encode_cohort(
        flat, offsets, key=jax_prng.fold_in(jax_prng.PRNGKey(5), 3))
    assert jax_prng.PARTITIONABLE == bool(
        jax.config.jax_threefry_partitionable)
    assert got["q"].dtype == torch.int8
    np.testing.assert_array_equal(got["q"].numpy(), want_q)
    np.testing.assert_array_equal(got["scale"].numpy(), want_s)
    assert not got["zero"].any()
    # the NaN row's leaf ('conv', columns 9-188) keeps its NaN scale and
    # codes 0
    assert bool(torch.isnan(got["scale"][1, 1]))
    assert not bool(got["q"][1, 9:189].any())


def test_split_counter_codes_match_reference_bitwise():
    """The older counter layout (JAX 0.4): ref.py's draw against the
    reference's with the flag switched for this test."""
    tree = _tree(1)
    flat, offsets = _flat(tree)
    old = bool(jax.config.jax_threefry_partitionable)
    jax.config.update("jax_threefry_partitionable", False)
    try:
        want_q, want_s = _ref_codes(tree, jax.random.PRNGKey(9))
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    keys = jax_prng.fold_in_many(jax_prng.PRNGKey(9),
                                 np.arange(offsets.numel() - 1))
    got = sr_ops.int8_sr_quantize(flat, torch.from_numpy(want_s), offsets,
                                  keys, partitionable=False)
    np.testing.assert_array_equal(got.numpy(), want_q)


def test_kernel_wrapper_checks_its_inputs():
    flat, offsets = _flat(_tree())
    scale = torch.ones((K, offsets.numel() - 1))
    keys = np.zeros((offsets.numel() - 1, 2), np.uint32)
    with pytest.raises(ValueError, match="keys"):
        sr_ops.int8_sr_quantize(flat, scale, offsets, keys[1:])
    with pytest.raises(ValueError, match="scale"):
        sr_ops.int8_sr_quantize(flat, scale[:, 1:], offsets, keys)
    with pytest.raises(ValueError, match="leaf_offsets"):
        sr_ops.int8_sr_quantize(flat, scale, offsets.flip(0), keys)
    with pytest.raises(ValueError, match="PRNG key"):
        make_codec("int8_sr").encode_cohort(flat, offsets)


def test_codec_is_unbiased():
    """The mean decode over 2,000 keys is x within 4 standard errors: each
    code is floor(y) or floor(y) + 1, the upper one with probability
    frac(y), so its variance is frac(1 - frac) scale². A code that is
    exact (frac 0: the leaf's max |x|) leaves the decode's two f32
    roundings (amax / 127, then q · scale): under 1e-6 of |x|."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 64)).astype(np.float32))
    offsets = torch.tensor([0, 24, 64])
    codec = make_codec("int8_sr")
    base = jax_prng.PRNGKey(11)
    dec = torch.stack([codec.decode_cohort(
        codec.encode_cohort(x, offsets, key=jax_prng.fold_in(base, i)),
        offsets) for i in range(2000)])
    scale = codec.encode_cohort(x, offsets, key=base)["scale"]
    per_col = torch.repeat_interleave(scale, torch.tensor([24, 40]), dim=1)
    frac = x / per_col - torch.floor(x / per_col)
    se = torch.sqrt(frac * (1 - frac) / 2000) * per_col
    err = (dec.mean(0) - x).abs()
    slack = 1e-6 * x.abs()
    assert bool((err <= 4 * se + slack).all()), \
        float((err / (se + slack)).max())


def test_plain_threefry_is_jax_prngs():
    """ref.py's int64 threefry against core/jax_prng's numpy one."""
    key = jax_prng.PRNGKey(21)
    for part in (True, False):
        n = torch.arange(37)
        got = sr_ref.draw_bits_ref(int(key[0]), int(key[1]), n, 37, part)
        np.testing.assert_array_equal(
            got.numpy().astype(np.uint32),
            jax_prng.random_bits(key, (37,), partitionable=part))


# ---------------- the trainer ----------------

ROUNDS = 3


@pytest.mark.parametrize("exec_kw,runtime", [
    ((("codec", "int8_sr"),), None),
    ((("async_buffer", True), ("buffer_size", 2), ("async_concurrency", 3),
      ("codec", "int8_sr"), ("codec_ef", True)), EXP),
], ids=["sync", "async_ef"])
def test_int8_sr_trainer_matches_reference(exec_kw, runtime):
    """Rounds (the sync key folds in t, a wave's the wave frontier) within
    the int8 tolerances of _torch_parity.assert_runs_match."""
    from _torch_parity import assert_runs_match, port_trainer, run_reference
    ref_run = run_reference("feddpc", ROUNDS, exec_kw, runtime)
    with port_trainer("feddpc", ROUNDS, exec_kw, runtime) as tr:
        tr.run()
        assert_runs_match(ref_run, tr, codec=True)
