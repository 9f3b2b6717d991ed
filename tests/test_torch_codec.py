"""repro_torch.codec against repro.codec on the CPU: the flat payload
(q, per-leaf scale and zero) and its decode, element for element, on a
multi-leaf tree with a leaf shorter than a warp, zero-range leaves and
rows holding NaN or Inf; the error-feedback residual; uplink bytes; and
the synchronous codec rounds of the trainer against the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import codec_names as ref_codec_names
from repro.codec import make_codec as ref_make_codec
from repro.codec.base import sanitized_residual as ref_sanitized_residual
from repro_torch.bridge import layout_of
from repro_torch.codec import codec_names, make_codec, sanitized_residual
from _torch_threads import one_intra_op_thread  # noqa: F401

K = 4
LOSSY = ["bf16", "int8", "int8_sym"]


def _tree(seed=0):
    """Client-stacked (K, ...) leaves: 'a' has 30 elements (< 32), 'b' a
    zero range in every row (one row all zeros), 'c' and 'conv' are
    ordinary; row 1 holds a NaN, row 2 a +Inf, row 3 a -Inf."""
    rng = np.random.default_rng(seed)
    tree = {"conv": rng.standard_normal((K, 3, 3, 4, 8)).astype(np.float32),
            "c": (rng.standard_normal((K, 40, 37)) * 3).astype(np.float32),
            "a": (rng.standard_normal((K, 6, 5)) * 1e-3).astype(np.float32),
            "b": np.repeat(np.asarray([0.0, 0.5, -2.0, 7.25], np.float32
                                      )[:, None], 64, axis=1)}
    tree["c"][1, 3, 4] = np.nan
    tree["a"][2, 0, 1] = np.inf
    tree["c"][3, 0, 0] = -np.inf
    return tree


def _flat(tree):
    """The port's view: the (K, N) stack in JAX's leaf order, and the
    layout's leaf offsets."""
    one = {k: v[0] for k, v in tree.items()}
    stacked = np.concatenate([tree[k].reshape(K, -1) for k in sorted(tree)],
                             axis=1)
    return torch.from_numpy(stacked), layout_of(one).leaf_offsets


def _ref_flat(payload_tree):
    """Reference per-leaf payload -> flat q (K, N), scale/zero (K, L)."""
    keys = sorted(payload_tree["q"])
    q = np.concatenate([np.asarray(payload_tree["q"][k]).reshape(K, -1)
                        for k in keys], axis=1)
    scale = np.stack([np.asarray(payload_tree["scale"][k]) for k in keys], 1)
    zero = np.stack([np.asarray(payload_tree["zero"][k]) for k in keys], 1)
    return q, scale, zero


def _as_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_registry_matches_reference_minus_int8_sr():
    """Every reference codec is registered in the port: int8_sr, the last
    one missing, too (its noise is the reference's, test_torch_int8_sr.py)."""
    assert set(ref_codec_names()) == set(codec_names())
    assert make_codec("int8_sr").config_dict() == {
        "name": "int8_sr", "symmetric": True, "stochastic": True}
    with pytest.raises(ValueError, match="unknown codec"):
        make_codec("int4")
    assert make_codec(None) is None and make_codec("") is None


def test_identity_returns_the_same_tensor():
    x, offsets = _flat(_tree())
    codec = make_codec("identity")
    assert not codec.lossy
    assert codec.encode_cohort(x, offsets) is x
    assert codec.decode_cohort(x, offsets) is x


@pytest.mark.parametrize("name", LOSSY)
def test_payload_and_decode_match_reference_bitwise(name):
    """Eager reference encode: the same f32 expressions in the same order
    give the same codes, scales, zero-points and decoded values, bit for
    bit — NaN and Inf included. Any differing q code is a fault."""
    tree = _tree()
    x, offsets = _flat(tree)
    ref = ref_make_codec(name)
    ref_payload = ref.encode_cohort({k: jnp.asarray(v)
                                     for k, v in tree.items()})
    ref_dec = ref.decode_cohort(ref_payload)
    payload = make_codec(name).encode_cohort(x, offsets)
    q, scale, zero = _ref_flat(ref_payload)
    assert payload["q"].dtype == {"bf16": torch.bfloat16}.get(name,
                                                              torch.int8)
    np.testing.assert_array_equal(_as_np(payload["q"]),
                                  q.astype(np.float32))
    np.testing.assert_array_equal(payload["scale"].numpy(), scale)
    np.testing.assert_array_equal(payload["zero"].numpy(), zero)
    dec = make_codec(name).decode_cohort(payload, offsets)
    want = np.concatenate([np.asarray(ref_dec[k]).reshape(K, -1)
                           for k in sorted(tree)], axis=1)
    np.testing.assert_array_equal(dec.numpy(), want)
    # the non-finite rows stay non-finite after decode (guard contract)
    for row in (1, 2, 3):
        assert not torch.isfinite(dec[row]).all()
    assert torch.isfinite(dec[0]).all()


@pytest.mark.parametrize("name", ["int8", "int8_sym"])
def test_payload_matches_reference_under_jit(name):
    """The reference trainer encodes inside jit, where XLA's simplifier
    turns the division by 254 (127) into a multiplication by its
    reciprocal: scale may then differ by 1 ulp, the codes must not."""
    tree = _tree(seed=1)
    x, offsets = _flat(tree)
    ref = ref_make_codec(name)
    q, scale, zero = _ref_flat(jax.jit(ref.encode_cohort)(
        {k: jnp.asarray(v) for k, v in tree.items()}))
    payload = make_codec(name).encode_cohort(x, offsets)
    np.testing.assert_array_equal(payload["q"].numpy(), q)
    for got, want in ((payload["scale"].numpy(), scale),
                      (payload["zero"].numpy(), zero)):
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite)
        ulps = np.abs(got[finite].view(np.int32).astype(np.int64)
                      - want[finite].view(np.int32).astype(np.int64))
        assert ulps.max(initial=0) <= 1


def test_sanitized_residual_matches_reference():
    tree = _tree()
    x, offsets = _flat(tree)
    codec = make_codec("int8")
    dec = codec.decode_cohort(codec.encode_cohort(x, offsets), offsets)
    got = sanitized_residual(x, dec)
    want = ref_sanitized_residual(jnp.asarray(x.numpy()),
                                  jnp.asarray(dec.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("name", ["identity"] + LOSSY)
def test_client_bytes_match_reference(name):
    tree = _tree()
    template = {k: jnp.asarray(v[0]) for k, v in tree.items()}
    numels = layout_of({k: v[0] for k, v in tree.items()}).numels
    want = ref_make_codec(name).client_bytes(template)
    assert make_codec(name).client_bytes(numels) == want
    n = sum(numels)
    assert want == {"identity": 4 * n, "bf16": 2 * n + 8 * 4}.get(
        name, n + 8 * 4)


# ---------------- synchronous codec rounds of the trainer ----------------

ROUNDS = 3


@pytest.mark.parametrize("exec_kw", [
    (("codec", "int8"),),
    (("codec", "int8"), ("codec_ef", True)),
    (("codec", "bf16"),),
], ids=["int8", "int8_ef", "bf16"])
def test_sync_codec_trainer_matches_reference(exec_kw):
    from _torch_parity import assert_runs_match, port_trainer, run_reference
    ref_run = run_reference("feddpc", ROUNDS, exec_kw)
    tr = port_trainer("feddpc", ROUNDS, exec_kw)
    tr.run()
    assert_runs_match(ref_run, tr, codec=True)
    if dict(exec_kw).get("codec_ef"):
        assert tr._ef is not None and float(tr._ef.abs().max()) > 0


def test_identity_codec_round_is_the_no_codec_round():
    from _torch_parity import port_trainer
    plain = port_trainer("feddpc", 2)
    ident = port_trainer("feddpc", 2, (("codec", "identity"),))
    plain.run()
    ident.run()
    assert torch.equal(plain.flat, ident.flat)
    assert [r.comm_bytes_up for r in ident.history] == \
        [r.comm_bytes_up for r in plain.history] == \
        [10 * 4 * plain.layout.size] * 2


def test_codec_ef_needs_a_lossy_codec():
    from _torch_parity import port_trainer
    with pytest.raises(ValueError, match="LOSSY"):
        port_trainer("feddpc", 1, (("codec", "identity"),
                                   ("codec_ef", True)))
