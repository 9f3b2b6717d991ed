"""repro_torch.bridge: JAX's leaf order, the flat parameter buffer and its
views, held against the reference's pytrees."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import ref_params
from repro_torch import bridge
from _torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("name", ["lenet5", "resnet18"])
def test_flat_buffer_is_jax_leaf_concatenation(name):
    params = ref_params(name)
    flat, layout = bridge.load_params(params)
    leaves = jax.tree.leaves(params)
    assert [tuple(x.shape) for x in leaves] == list(layout.shapes)
    want = np.concatenate([x.ravel() for x in leaves])
    # exact: the flat buffer is a copy, element for element
    np.testing.assert_array_equal(flat.numpy(), want)
    assert layout.size == want.size == int(flat.shape[0])


def test_unflatten_gives_views_in_reference_structure():
    params = ref_params("resnet18")
    flat, layout = bridge.load_params(params)
    tree = layout.unflatten(flat)
    leaves_before = params["stem"].copy()
    assert jax.tree.structure(jax.tree.map(lambda x: 0, tree)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, params))
    for a, b in zip(bridge.tree_leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a.numpy(), b)
    flat.mul_(2.0)                      # views share the buffer...
    assert np.array_equal(params["stem"], leaves_before)  # ...not params
    np.testing.assert_array_equal(tree["stem"].numpy(), 2 * params["stem"])
    back = layout.to_numpy(flat)
    np.testing.assert_array_equal(back["blocks"][2]["proj"],
                                  2 * params["blocks"][2]["proj"])


def test_stack_unflatten_rows_match_per_row_views():
    params = ref_params("lenet5")
    flat, layout = bridge.load_params(params)
    rng = np.random.default_rng(0)
    stack = torch.from_numpy(rng.standard_normal((3, layout.size),
                                                 dtype=np.float32))
    trees = layout.unflatten(stack)
    for j in range(3):
        row = layout.unflatten(stack[j])
        for a, b in zip(bridge.tree_leaves(trees), bridge.tree_leaves(row)):
            assert a.shape[0] == 3
            torch.testing.assert_close(a[j], b, rtol=0, atol=0)


def test_flatten_rejects_a_mismatched_tree():
    params = ref_params("lenet5")
    _, layout = bridge.load_params(params)
    bad = dict(params, c1=np.zeros((3, 3, 3, 6), np.float32))
    with pytest.raises(ValueError, match="does not match"):
        layout.flatten(bad)
    with pytest.raises(ValueError, match="elements"):
        layout.unflatten(torch.zeros(layout.size + 1))


def test_to_torch_to_numpy_round_trip():
    tree = {"b": [np.arange(3.0), {"z": np.ones((2, 2))}], "a": None}
    back = bridge.to_numpy(bridge.to_torch(tree))
    np.testing.assert_array_equal(back["b"][0], tree["b"][0])
    np.testing.assert_array_equal(back["b"][1]["z"], tree["b"][1]["z"])
    assert back["a"] is None
    assert [p for p, _ in bridge.tree_leaves_with_path(tree)] == \
        [("b", 0), ("b", 1, "z")]
