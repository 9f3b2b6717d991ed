"""repro_torch attention against the reference on the same numpy inputs:
the flash-attention kernel's plain version (``attention_ref``, which the
wrapper runs on CPU tensors) against the reference's oracle and its
Pallas kernel in interpret mode; ``sdpa``'s reference and blocked paths
against the reference's; ``gqa_forward`` with and without a ring-buffer
cache (outputs and cache contents)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import starcoder2_3b as ref_sc2
from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.flash_attention import ref as ref_fa_ref
from repro.models import attention as ref_attn
from repro_torch.configs import starcoder2_3b
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import attention
from _torch_threads import one_intra_op_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, sq, sk, h, kv, d):
    """q, k, v as numpy f32 (rounded to bf16 in both packages alike)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _positions(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None],
                           (b, s)).copy()


def _check_all(q, k, v, q_pos, k_pos, dtype="float32", **kw):
    """The port's plain version against the reference's oracle and its
    Pallas kernel (interpret mode); returns the port's output."""
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], dtype)
    got = fa_ref.attention_ref(tq, tk, tv, torch.from_numpy(q_pos),
                               torch.from_numpy(k_pos), **kw)
    # the reference's own kernel tolerances (tests/test_kernels.py)
    tol = 2e-5 if dtype == "float32" else 4e-2
    assert got.dtype == DTYPES[dtype][1]
    wants = {"oracle": ref_fa_ref.attention_ref(jq, jk, jv, q_pos, k_pos,
                                                **kw),
             "kernel (interpret)": ref_fa_ops.flash_attention(
                 jq, jk, jv, q_pos, k_pos, **kw)}
    for name, want in wants.items():
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol,
                                   err_msg=f"attention_ref vs the "
                                           f"reference's {name}")
    return got


@pytest.mark.parametrize("b,sq,sk,h,kv,d", [
    (2, 256, 256, 8, 2, 64),
    (1, 128, 128, 4, 4, 128),
    (1, 100, 100, 4, 2, 64),          # the reference's pad path
    (2, 64, 64, 16, 8, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_reference_sweep(b, sq, sk, h, kv, d, dtype):
    q, k, v = _inputs(0, b, sq, sk, h, kv, d)
    _check_all(q, k, v, _positions(b, sq), _positions(b, sk), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_sliding_window(dtype):
    b, s, h, kv, d = 2, 384, 8, 2, 64
    q, k, v = _inputs(1, b, s, s, h, kv, d)
    pos = _positions(b, s)
    _check_all(q, k, v, pos, pos, dtype, window=100)


def test_attention_ref_ring_cache_decode():
    """Decode against a partly filled ring cache (-1 = empty slots),
    slots out of position order, with a window."""
    b, sk, h, kv, d = 2, 300, 16, 2, 128
    q, k, v = _inputs(2, b, 1, sk, h, kv, d)
    q_pos = np.full((b, 1), 400, np.int32)
    k_pos = np.roll(_positions(b, sk, start=101), 37, axis=1)
    k_pos[:, -7:] = -1
    _check_all(q, k, v, q_pos, k_pos, window=128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_soft_cap(dtype):
    b, s, h, kv, d = 1, 96, 4, 2, 64
    q, k, v = _inputs(3, b, s, s, h, kv, d)
    q *= 6.0                              # scores well past the cap
    pos = _positions(b, s)
    _check_all(q, k, v, pos, pos, dtype, soft_cap=30.0)


def test_attention_ref_all_masked_row_is_zero():
    """A batch row whose keys are all empty slots, and a query before
    every key: 0 on both sides (p = 0 where masked, l floored)."""
    b, sq, sk, h, kv, d = 2, 8, 40, 4, 2, 32
    q, k, v = _inputs(4, b, sq, sk, h, kv, d)
    q_pos = _positions(b, sq, start=10)
    q_pos[1, 0] = 5                       # before row 1's first key
    k_pos = _positions(b, sk, start=6)
    k_pos[0] = -1                         # batch row 0: all slots empty
    got = _check_all(q, k, v, q_pos, k_pos)
    assert float(got[0].abs().max()) == 0.0
    assert float(got[1, 0].abs().max()) == 0.0
    assert float(got[1, 1:].abs().min()) > 0.0
    # the wrapper on CPU tensors runs the plain version, and counts nothing
    before = fa_ops.flash_attention.launches
    wrapped = fa_ops.flash_attention(
        *[torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)])
    assert torch.equal(wrapped, got)
    assert fa_ops.flash_attention.launches == before


def test_flash_attention_wrapper_rejects_bad_inputs():
    q, k, v = [torch.from_numpy(a) for a in _inputs(5, 1, 4, 6, 4, 2, 16)]
    qp, kp = torch.zeros(1, 4, dtype=torch.int32), torch.zeros(
        1, 6, dtype=torch.int32)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k[:, :, :1].expand(1, 6, 3, 16).clone(),
                               v[:, :, :1].expand(1, 6, 3, 16).clone(), qp,
                               kp)                   # H % KV != 0
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, v, qp, kp[:, :5])
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.double(), k.double(), v.double(), qp, kp)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, k, v, qp.float(), kp)


@pytest.mark.parametrize("impl", ["reference", "blocked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_matches_reference(impl, dtype):
    b, sq, sk, h, kv, d = 2, 40, 1100, 6, 2, 32
    q, k, v = _inputs(6, b, sq, sk, h, kv, d)
    q_pos = _positions(b, sq, start=1000)
    k_pos = _positions(b, sk)
    k_pos[:, -30:] = -1
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], dtype)
    for kw in ({"window": 0}, {"window": 300, "soft_cap": 5.0}):
        got = attention.sdpa(tq, tk, tv, torch.from_numpy(q_pos),
                             torch.from_numpy(k_pos), impl=impl, **kw)
        want = ref_attn.sdpa(jq, jk, jv, q_pos, k_pos, impl=impl, **kw)
        tol = 2e-5 if dtype == "float32" else 4e-2
        assert got.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_sdpa_auto_follows_the_reference_rule_on_cpu():
    """On the CPU "auto" is the reference's choice: blocked above
    BLOCKED_THRESHOLD keys with Sq > 8, reference otherwise — told apart
    by the fully masked row, where the two give different answers."""
    b, h, kv, d = 1, 2, 1, 8
    for sq, sk, want_impl in ((9, 2049, "blocked"), (8, 2049, "reference"),
                              (9, 2048, "reference")):
        q, k, v = _inputs(7, b, sq, sk, h, kv, d)
        q_pos = _positions(b, sq, start=sk)
        q_pos[0, 0] = -1                   # this row sees no key
        k_pos = _positions(b, sk)
        args = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
        got = attention.sdpa(*args)
        assert torch.equal(got, attention.sdpa(*args, impl=want_impl))
        want = ref_attn.sdpa(*[jnp.asarray(a)
                               for a in (q, k, v, q_pos, k_pos)])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError):
        attention.sdpa(*args, impl="pallas")


def test_fully_masked_row_differs_by_impl_as_in_the_reference():
    """The reference's own difference, kept: "reference" gives the uniform
    mean of v, the kernel's plain version 0."""
    q, k, v = _inputs(8, 1, 1, 16, 2, 1, 8)
    q_pos = np.full((1, 1), -1, np.int32)
    k_pos = _positions(1, 16)
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    uniform = attention.sdpa(*t, impl="reference")
    np.testing.assert_allclose(uniform[0, 0, 0].numpy(),
                               v[0, :, 0].mean(0), rtol=1e-5, atol=1e-6)
    assert float(attention.sdpa(*t, impl="kernel").abs().max()) == 0.0


@functools.lru_cache(maxsize=None)
def _gqa_params():
    """The reference's GQA params for StarCoder2 SMOKE with biases (numpy)
    and the port's copy."""
    rcfg = ref_sc2.SMOKE
    p = ref_attn.init_gqa(jax.random.PRNGKey(3), rcfg, jnp.float32)
    # non-zero biases, so the bias path is compared too
    rng = np.random.default_rng(9)
    p = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.standard_normal(
        x.shape).astype(np.float32) * (x.ndim == 1), p)
    return p


def _port(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _ref_cache(cache):
    return {k: np.asarray(x) for k, x in cache.items()}


@pytest.mark.parametrize("window", [0, 6])
def test_gqa_forward_matches_reference(window):
    """No cache (full sequence), then a cache: prefill 5 tokens into 8
    slots and decode 5 steps, the ring wrapping at the fourth; outputs and
    the cache's k, v, pos and idx after every step."""
    rcfg, cfg = ref_sc2.SMOKE, starcoder2_3b.SMOKE
    np_p = _gqa_params()
    p = _port(np_p)
    rng = np.random.default_rng(10)
    b, s0 = 2, 5
    x = rng.standard_normal((b, s0, cfg.d_model), dtype=np.float32)
    pos = _positions(b, s0)
    want, _ = ref_attn.gqa_forward(rcfg, np_p, x, pos, window=window)
    got, none = attention.gqa_forward(cfg, p, torch.from_numpy(x),
                                      torch.from_numpy(pos), window=window)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    rcache = ref_attn.init_kv_cache(rcfg, b, 8, jnp.float32)
    cache = attention.init_kv_cache(cfg, b, 8, torch.float32)
    steps = [(x, pos)] + [
        (rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32),
         np.full((b, 1), s0 + i, np.int32)) for i in range(5)]
    for xi, pi in steps:
        want, rcache = ref_attn.gqa_forward(rcfg, np_p, xi, pi,
                                            window=window, cache=rcache)
        got, cache = attention.gqa_forward(cfg, p, torch.from_numpy(xi),
                                           torch.from_numpy(pi),
                                           window=window, cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        rc = _ref_cache(rcache)
        assert cache["idx"] == int(rc["idx"])
        assert np.array_equal(cache["pos"].numpy(), rc["pos"])
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(), rc[key],
                                       rtol=1e-5, atol=1e-5)
    assert cache["idx"] == 10 and int(cache["pos"].min()) == 2   # wrapped


def test_cache_write_longer_than_capacity_raises():
    cfg = starcoder2_3b.SMOKE
    cache = attention.init_kv_cache(cfg, 1, 4, torch.float32)
    x = torch.zeros(1, 5, cfg.num_kv_heads, cfg.resolved_head_dim)
    with pytest.raises(ValueError, match="capacity 4"):
        attention._cache_write(cache, x, x, torch.zeros(1, 5,
                                                        dtype=torch.int32))


def test_mla_is_not_ported():
    """MLA is ported (held against the reference in test_torch_moe.py):
    its cache holds the compressed latent and the shared RoPE key, and a
    wrapping write keeps the ring's order, as a GQA cache's."""
    cfg = starcoder2_3b.SMOKE.with_(attention="mla", kv_lora_rank=16,
                                    q_lora_rank=24, qk_nope_head_dim=8,
                                    qk_rope_head_dim=4, v_head_dim=8)
    cache = attention.init_cache(cfg, 1, 4, torch.float32)
    assert {k: tuple(v.shape) for k, v in cache.items() if k != "idx"} == {
        "c_kv": (1, 4, 16), "k_rope": (1, 4, 4), "pos": (1, 4)}
    cache["idx"] = 3
    c = torch.arange(2 * 16, dtype=torch.float32).reshape(1, 2, 16)
    r = torch.ones(1, 2, 4)
    new = attention._ring_write(cache, {"c_kv": c, "k_rope": r},
                                torch.tensor([[3, 4]]))
    assert new["idx"] == 5 and new["pos"].tolist() == [[4, -1, -1, 3]]
    assert torch.equal(new["c_kv"][0, 3], c[0, 0])
    assert torch.equal(new["c_kv"][0, 0], c[0, 1])
