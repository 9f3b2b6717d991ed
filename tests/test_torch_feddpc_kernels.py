"""repro_torch.kernels.feddpc_project: the plain versions (what the
wrappers run on CPU tensors) against the reference's Pallas kernels in
interpret mode, as tests/test_kernels.py runs them, and against the
reference's jnp oracles. The CUDA kernels are held against the plain
versions on the card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.feddpc_project import ops as ref_ops
from repro.kernels.feddpc_project import ref as ref_ref
from repro_torch.kernels.feddpc_project import ops, ref

SHAPES = [(1, 37), (3, 1000), (7, 70001)]


def _case(k, n, zero_prev, seed=0):
    """Seeded numpy inputs: d (k, n), p, w (n,), coefs, scales (k,)."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((k, n), dtype=np.float32)
    p = (np.zeros(n, np.float32) if zero_prev
         else rng.standard_normal(n, dtype=np.float32))
    w = rng.standard_normal(n, dtype=np.float32)
    coefs = rng.standard_normal(k, dtype=np.float32)
    scales = (1.0 + np.abs(rng.standard_normal(k))).astype(np.float32)
    return d, p, w, coefs, scales


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_dots_close(got, want, dd, pp):
    # f32 sums in different orders: relative to sqrt(<d,d><p,p>) for the
    # cross term (Cauchy-Schwarz) and to the norms themselves
    scale = np.stack([np.sqrt(dd * pp), dd, pp], -1).clip(min=1.0)
    assert np.max(np.abs(got - want) / scale) <= 1e-5


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("zero_prev", [False, True])
def test_dots_match_pallas_fused_dots(k, n, zero_prev):
    d, p, _, _, _ = _case(k, n, zero_prev)
    got = ops.feddpc_dots(*_t(d, p)).numpy()
    pallas = np.stack([np.asarray(ref_ops.fused_dots_flat(
        jnp.asarray(d[j]), jnp.asarray(p), interpret=True))
        for j in range(k)])
    oracle = np.stack([np.asarray(ref_ref.dots_ref(jnp.asarray(d[j]),
                                                   jnp.asarray(p)))
                       for j in range(k)])
    assert got.shape == (k, 3) and got.dtype == np.float32
    for want in (pallas, oracle):
        _assert_dots_close(got, want, want[:, 1], want[:, 2])
    if zero_prev:
        assert np.all(got[:, 0] == 0) and np.all(got[:, 2] == 0)


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("zero_prev", [False, True])
def test_batched_epilogue_matches_pallas(k, n, zero_prev):
    d, p, w, coefs, scales = _case(k, n, zero_prev, seed=1)
    got_w, got_dt = ops.feddpc_batched_epilogue(*_t(d, p, w, coefs, scales),
                                                0.3)
    want_w, want_dt = ref_ops.batched_server_epilogue(
        {"x": jnp.asarray(d)}, {"x": jnp.asarray(p)}, {"x": jnp.asarray(w)},
        jnp.asarray(coefs), jnp.asarray(scales), 0.3, interpret=True)
    # element-wise identical math; only the K-sum order may differ
    np.testing.assert_allclose(got_dt.numpy(), np.asarray(want_dt["x"]),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w["x"]),
                               rtol=2e-6, atol=2e-6)
    o_w, o_dt = ref_ref.batched_epilogue_ref(
        jnp.asarray(d)[:, None], jnp.asarray(p)[None], jnp.asarray(w)[None],
        coefs, scales, 0.3)
    np.testing.assert_allclose(got_dt.numpy(), np.asarray(o_dt)[0],
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(o_w)[0],
                               rtol=2e-6, atol=2e-6)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    d, p, w, coefs, scales = _t(*_case(3, 100, False))
    before = [fn.launches for fn in ops.KERNELS]
    torch.testing.assert_close(ops.feddpc_dots(d, p), ref.dots_ref(d, p),
                               rtol=0, atol=0)
    got = ops.feddpc_batched_epilogue(d, p, w, coefs, scales, 0.5)
    want = ref.batched_epilogue_ref(d, p, w, coefs, scales, 0.5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [fn.launches for fn in ops.KERNELS] == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    d, p, w, coefs, scales = _t(*_case(3, 100, False))
    with pytest.raises(TypeError, match="float32"):
        ops.feddpc_dots(d.double(), p.double())
    with pytest.raises(TypeError, match="float32"):
        ops.feddpc_batched_epilogue(d, p, w.bfloat16(), coefs, scales, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.feddpc_dots(torch.zeros(100, 3).t(), p)
    with pytest.raises(ValueError, match="p must be"):
        ops.feddpc_dots(d, p[:-1])
    with pytest.raises(ValueError, match="coefs must be"):
        ops.feddpc_batched_epilogue(d, p, w, coefs[:2], scales, 0.1)
    with pytest.raises(ValueError, match=r"\(K, N\)"):
        ops.feddpc_dots(d[0], p)


# ---- the three folds of the buffered-async and codec rounds, on a
# multi-leaf tree: 'a' is shorter than a warp, so leaf boundaries fall
# inside the kernels' column tiles ----

TREE = {"a": (6, 5), "b": (64,), "c": (40, 37), "conv": (3, 3, 4, 8)}


def _tree_case(k, codec, seed):
    """Reference trees (client-stacked deltas; prev, params), the
    reference's payload of the deltas, and the port's flat views."""
    from repro.codec import make_codec as ref_make_codec
    from repro_torch.bridge import layout_of
    rng = np.random.default_rng(seed)
    deltas = {n: rng.standard_normal((k,) + s, dtype=np.float32)
              for n, s in TREE.items()}
    prev = {n: rng.standard_normal(s, dtype=np.float32)
            for n, s in TREE.items()}
    params = {n: rng.standard_normal(s, dtype=np.float32)
              for n, s in TREE.items()}
    coefs = rng.standard_normal(k, dtype=np.float32)
    scales = (1.0 + np.abs(rng.standard_normal(k))).astype(np.float32)
    wgts = rng.uniform(0.2, 1.0, k).astype(np.float32)
    payload = ref_make_codec(codec).encode_cohort(
        {n: jnp.asarray(v) for n, v in deltas.items()})
    keys = sorted(TREE)

    def flat(tree, lead):
        return torch.from_numpy(np.concatenate(
            [np.asarray(tree[n]).reshape(lead + (-1,)) for n in keys], -1))

    port = {"d": flat(deltas, (k,)), "p": flat(prev, ()),
            "w": flat(params, ()),
            "q": torch.from_numpy(np.concatenate(
                [np.asarray(payload["q"][n].astype(jnp.float32)
                            ).reshape(k, -1) for n in keys], -1)),
            "qscale": torch.from_numpy(np.stack(
                [np.asarray(payload["scale"][n]) for n in keys], 1)),
            "qzero": torch.from_numpy(np.stack(
                [np.asarray(payload["zero"][n]) for n in keys], 1)),
            "offsets": layout_of(params).leaf_offsets}
    port["q"] = port["q"].to(torch.int8 if codec.startswith("int8")
                             else torch.bfloat16)
    scalars = [torch.from_numpy(x) for x in (coefs, scales, wgts)]
    return (deltas, prev, params, payload, coefs, scales, wgts), port, \
        scalars


def _assert_fold_close(got, want_tree):
    """Δ_t and w' within 1e-6 absolute: the same element-wise math, with
    the sum over rows in another order (the reference's kernel multiplies
    each arrival by 1/B, the port divides the sum once)."""
    want_w, want_dt = want_tree
    for g, wt in zip(got, (want_w, want_dt)):
        want = np.concatenate([np.asarray(wt[n]).reshape(-1)
                               for n in sorted(TREE)])
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 5])
def test_buffer_fold_matches_pallas(k):
    (deltas, prev, params, _, coefs, scales, wgts), port, (c, s, wg) = \
        _tree_case(k, "int8", seed=k)
    got = ops.feddpc_buffer_fold(port["d"], port["p"], port["w"], c, s, wg,
                                 0.3)
    want = ref_ops.buffered_server_fold(
        deltas, prev, params, jnp.asarray(coefs), jnp.asarray(scales),
        jnp.asarray(wgts), 0.3, interpret=True)
    _assert_fold_close(got, want)


@pytest.mark.parametrize("codec", ["int8", "int8_sym", "bf16"])
@pytest.mark.parametrize("k", [1, 5])
def test_dequant_folds_match_pallas(codec, k):
    (_, prev, params, payload, coefs, scales, wgts), port, (c, s, wg) = \
        _tree_case(k, codec, seed=10 + k)
    flat_payload = (port["q"], port["qscale"], port["qzero"],
                    port["offsets"], port["p"], port["w"], c, s)
    _assert_fold_close(
        ops.feddpc_dequant_batched_epilogue(*flat_payload, 0.3),
        ref_ops.dequant_batched_server_epilogue(
            payload, prev, params, jnp.asarray(coefs), jnp.asarray(scales),
            0.3, interpret=True))
    _assert_fold_close(
        ops.feddpc_dequant_buffer_fold(*flat_payload, wg, 0.3),
        ref_ops.dequant_buffered_server_fold(
            payload, prev, params, jnp.asarray(coefs), jnp.asarray(scales),
            jnp.asarray(wgts), 0.3, interpret=True))


def test_dequant_ref_is_the_codec_decode():
    """The plain dequant equals the reference codec's decode bitwise."""
    from repro.codec import make_codec as ref_make_codec
    (deltas, _, _, payload, *_), port, _ = _tree_case(4, "int8", seed=3)
    dec = ref_make_codec("int8").decode_cohort(payload)
    want = np.concatenate([np.asarray(dec[n]).reshape(4, -1)
                           for n in sorted(TREE)], -1)
    got = ref.dequant_ref(port["q"], port["qscale"], port["qzero"],
                          port["offsets"])
    np.testing.assert_array_equal(got.numpy(), want)


def test_fold_wrappers_reject_what_the_kernels_do_not_take():
    _, port, (c, s, wg) = _tree_case(3, "int8", seed=0)
    q, qs, qz, offs = port["q"], port["qscale"], port["qzero"], \
        port["offsets"]
    p, w = port["p"], port["w"]
    with pytest.raises(TypeError, match="int8"):
        ops.feddpc_dequant_batched_epilogue(q.float(), qs, qz, offs, p, w,
                                            c, s, 0.1)
    with pytest.raises(ValueError, match="qzero must be"):
        ops.feddpc_dequant_buffer_fold(q, qs, qz[:, :-1], offs, p, w, c, s,
                                       wg, 0.1)
    with pytest.raises(ValueError, match="wgts must be"):
        ops.feddpc_buffer_fold(port["d"][:3], p, w, c, s, wg[:2], 0.1)
    bad = offs.clone()
    bad[2] = bad[1]
    for offsets, match in ((bad, "strictly increasing"),
                           (offs.int(), "CPU int64"),
                           (offs[:-1], "CPU int64")):
        with pytest.raises(ValueError, match=match):
            ops.feddpc_dequant_batched_epilogue(q, qs, qz, offsets, p, w, c,
                                                s, 0.1)


# ---- the update guard's reduction pass and the one-client epilogue ----

def _guard_case(k, n, seed):
    """d (k, n) with, per row: clean, scattered NaN/+-Inf, all NaN, x1e12."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((k, n), dtype=np.float32)
    p = rng.standard_normal(n, dtype=np.float32)
    for j in range(k):
        kind = j % 4
        if kind == 1:
            at = rng.choice(n, size=min(n, 5), replace=False)
            d[j, at] = np.asarray([np.nan, np.inf, -np.inf, np.nan,
                                   np.inf][:len(at)], np.float32)
        elif kind == 2:
            d[j] = np.nan
        elif kind == 3:
            d[j] *= np.float32(1e12)
    return d, p


@pytest.mark.parametrize("k,n", [(1, 37), (4, 1000), (5, 70001)])
def test_guard_dots_match_pallas_guard_dots(k, n):
    """[<d~,p>, <d~,d~>, <p,p>, nonfinite(d)] against the reference's
    Pallas ``guard_dots`` (interpret mode) and its ``guard_dots_ref``, row
    by row; the count exactly. Without p, columns 1 and 3 are the same
    and columns 0 and 2 are 0."""
    d, p = _guard_case(k, n, seed=k)
    got = ops.feddpc_guard_dots(*_t(d, p)).numpy()
    got_nop = ops.feddpc_guard_dots(torch.from_numpy(d)).numpy()
    pallas = np.stack([np.asarray(ref_ops.guard_dots_flat(
        jnp.asarray(d[j]), jnp.asarray(p), interpret=True))
        for j in range(k)])
    oracle = np.stack([np.asarray(ref_ref.guard_dots_ref(
        jnp.asarray(d[j]), jnp.asarray(p))) for j in range(k)])
    assert got.shape == got_nop.shape == (k, 4)
    for want in (pallas, oracle):
        assert np.isfinite(want[:, :3]).all()
        _assert_dots_close(got[:, :3], want[:, :3], want[:, 1], want[:, 2])
        np.testing.assert_array_equal(got[:, 3], want[:, 3])
        np.testing.assert_array_equal(got_nop[:, 3], want[:, 3])
        scale = np.clip(want[:, 1], 1.0, None)
        assert np.max(np.abs(got_nop[:, 1] - want[:, 1]) / scale) <= 1e-5
    assert (got_nop[:, [0, 2]] == 0).all()
    expect = [{0: 0, 1: min(n, 5), 2: n, 3: 0}[j % 4] for j in range(k)]
    assert got[:, 3].tolist() == expect


@pytest.mark.parametrize("n", [37, 70001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zero_prev", [False, True])
def test_epilogue_matches_pallas_fused_epilogue(n, dtype, zero_prev):
    """out = scale * (d - coef * p) in d's dtype: the plain version
    against the reference's Pallas ``fused_epilogue`` (interpret mode),
    given the same coef and scale; then the two-pass
    ``project_and_scale_flat`` against the reference's."""
    d, p, _, coefs, scales = _case(1, n, zero_prev, seed=n)
    d_t = torch.from_numpy(d[0]).to(dtype)
    d_j = jnp.asarray(d[0]).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                   else jnp.float32)
    # bf16: both round the same f32 value, which may differ in its last
    # f32 bits (sum orders): at most one bf16 step, 2^-7 relative
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=1e-6)
    got = ops.feddpc_fused_epilogue(d_t, torch.from_numpy(p),
                                    torch.from_numpy(coefs),
                                    torch.from_numpy(scales))
    want = ref_ops.residual_scale_tree(
        {"x": d_j}, {"x": jnp.asarray(p)}, jnp.float32(coefs[0]),
        jnp.float32(scales[0]), interpret=True)["x"]
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    got = ops.project_and_scale_flat(d_t, torch.from_numpy(p), 0.7)
    want = ref_ops.project_and_scale_flat(d_j, jnp.asarray(p), 0.7,
                                          interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(
        ref.project_and_scale_flat_ref(d_t, torch.from_numpy(p),
                                       0.7).float().numpy(),
        np.asarray(ref_ref.project_and_scale_flat_ref(
            d_j, jnp.asarray(p), 0.7).astype(jnp.float32)), **tol)


def test_project_and_scale_matches_reference_with_the_kernel():
    """projection.project_and_scale(use_kernel=True) on the flat view of a
    multi-leaf tree against the reference's on the tree, whose epilogue
    is the Pallas ``fused_epilogue`` per leaf (interpret mode)."""
    from repro.core import projection as ref_proj
    from repro_torch.core import projection as proj
    (deltas, prev, _, _, _, _, _), port, _ = _tree_case(1, "int8", seed=4)
    tree = {n: jnp.asarray(v[0]) for n, v in deltas.items()}
    want, want_diag = ref_proj.project_and_scale(
        tree, {n: jnp.asarray(v) for n, v in prev.items()}, 0.9,
        use_kernel=True)
    got, diag = proj.project_and_scale(port["d"][0], port["p"], 0.9,
                                       use_kernel=True)
    want_flat = np.concatenate([np.asarray(want[n]).reshape(-1)
                                for n in sorted(TREE)])
    np.testing.assert_allclose(got.numpy(), want_flat, rtol=1e-6, atol=1e-6)
    assert set(diag) == set(want_diag)
    for key, value in want_diag.items():
        np.testing.assert_allclose(float(diag[key]), float(value),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_guard_and_epilogue_wrappers_check_their_inputs():
    d, p, _, coefs, scales = _t(*_case(3, 100, False))
    before = [fn.launches for fn in ops.KERNELS]
    torch.testing.assert_close(ops.feddpc_guard_dots(d, p),
                               ref.guard_dots_ref(d, p), rtol=0, atol=0)
    torch.testing.assert_close(
        ops.feddpc_fused_epilogue(d[0], p, coefs[0], scales[:1]),
        ref.epilogue_ref(d[0], p, coefs[0], scales[0]), rtol=0, atol=0)
    assert [fn.launches for fn in ops.KERNELS] == before
    with pytest.raises(TypeError, match="float32"):
        ops.feddpc_guard_dots(d.bfloat16())
    with pytest.raises(ValueError, match="p must be"):
        ops.feddpc_guard_dots(d, p[:-1])
    with pytest.raises(ValueError, match=r"\(N,\)"):
        ops.feddpc_fused_epilogue(d, p, coefs[0], scales[0])
    with pytest.raises(TypeError, match="float16"):
        ops.feddpc_fused_epilogue(d[0].half(), p, coefs[0], scales[0])
    with pytest.raises(ValueError, match="coef must be"):
        ops.feddpc_fused_epilogue(d[0], p, coefs, scales[0])
    with pytest.raises(TypeError, match="scale must be float32"):
        ops.feddpc_fused_epilogue(d[0], p, coefs[0], scales[0].double())
