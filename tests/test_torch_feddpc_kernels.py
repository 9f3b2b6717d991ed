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
