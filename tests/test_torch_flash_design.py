"""The arithmetic of the flash-attention kernel's bodies, checked on the
CPU against the reference's oracle (``repro.kernels.flash_attention.ref.
attention_ref``) and its Pallas kernel in interpret mode, on the same numpy
inputs:

  * the split decode's plain version, ``ref.attention_split_ref`` —
    per-chunk partials (m, l, acc) merged in chunk order — at chunks of 1,
    7, 64 and 128 keys and more than Sk, with dark chunks, a ring-cache
    decode with a window and a batch row whose keys are all empty;
  * a model of the tensor-core body's rounding (q and k exact in bf16,
    1/sqrt(D) applied to the f32 scores after the product, an online
    softmax over key tiles of 64, P rounded to bf16 — one part, or P_hi +
    P_lo — before P.V);
  * the card's bf16 gate (``ref.bf16_steps``): it passes the split's
    plain version and catches a merge that drops one chunk, which the
    reference's bf16 tolerance alone lets through at a long cache;
  * the wrapper's route plan.

Tolerances are the reference's kernel tolerances (tests/test_kernels.py):
2e-5 in f32 (sums in other orders), 4e-2 in bf16 (outputs rounded from
f32 values that differ in their last bits)."""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.flash_attention import ref as ref_fa_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from _torch_threads import one_intra_op_thread  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 4e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the reference's flash-attention sweep (tests/test_kernels.py)
SWEEP = [(2, 256, 256, 8, 2, 64),
         (1, 128, 128, 4, 4, 128),
         (1, 100, 100, 4, 2, 64),
         (2, 64, 64, 16, 8, 32)]
CHUNKS = [1, 7, 64, 128, "past_sk"]


def _inputs(seed, b, sq, sk, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


def _positions(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None],
                           (b, s)).copy()


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _reference(arrays, dtype, **kw):
    """The reference's oracle and its Pallas kernel (interpret mode) on
    q, k, v (numpy f32, cast to dtype) and the positions."""
    q, k, v, q_pos, k_pos = arrays
    jq, jk, jv = [jnp.asarray(a).astype(DTYPES[dtype][0]) for a in (q, k, v)]
    return [_f32(fn(jq, jk, jv, q_pos, k_pos, **kw))
            for fn in (ref_fa_ref.attention_ref, ref_fa_ops.flash_attention)]


def _torch(arrays, dtype):
    q, k, v, q_pos, k_pos = arrays
    tdt = DTYPES[dtype][1]
    return ([torch.from_numpy(a).to(tdt) for a in (q, k, v)]
            + [torch.from_numpy(q_pos), torch.from_numpy(k_pos)])


@functools.lru_cache(maxsize=None)
def _sweep_case(shape, dtype):
    b, sq, sk, h, kv, d = shape
    arrays = _inputs(0, *shape) + [_positions(b, sq), _positions(b, sk)]
    return arrays, _reference(arrays, dtype)


def _chunk(chunk, sk):
    return sk + 5 if chunk == "past_sk" else chunk


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ref_matches_reference_sweep(shape, dtype, chunk):
    arrays, wants = _sweep_case(shape, dtype)
    got = fa_ref.attention_split_ref(*_torch(arrays, dtype),
                                     chunk=_chunk(chunk, shape[2]))
    assert got.dtype == DTYPES[dtype][1] and got.shape == arrays[0].shape
    for want in wants:
        np.testing.assert_allclose(_f32(got), want, rtol=TOL[dtype],
                                   atol=TOL[dtype])


@functools.lru_cache(maxsize=None)
def _ring_case(dtype):
    """A decode against a ring cache of 300 slots, partly empty, slots out
    of position order, window 128 (dark chunks), and a batch row
    whose slots are all empty."""
    b, sk, h, kv, d = 3, 300, 16, 2, 128
    q, k, v = _inputs(2, b, 1, sk, h, kv, d)
    q_pos = np.full((b, 1), 400, np.int32)
    k_pos = np.roll(_positions(b, sk, start=101), 37, axis=1)
    k_pos[:, -7:] = -1
    k_pos[1] = -1
    arrays = [q, k, v, q_pos, k_pos]
    return arrays, _reference(arrays, dtype, window=128)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ref_ring_decode_with_dark_chunks(dtype, chunk):
    arrays, wants = _ring_case(dtype)
    k_pos = arrays[4]
    c = _chunk(chunk, k_pos.shape[1])
    n = -(-k_pos.shape[1] // c)
    padded = np.pad(k_pos[0], (0, n * c - k_pos.shape[1]), constant_values=-1)
    live = ((padded >= 0) & (padded > 400 - 128)).reshape(n, c).any(axis=1)
    if c < 128:
        assert not live.all()                       # dark chunks
    if c < 64:
        assert (~live).sum() > live.sum()           # most of them dark
    got = fa_ref.attention_split_ref(*_torch(arrays, dtype), window=128,
                                     chunk=c)
    for want in wants:
        np.testing.assert_allclose(_f32(got), want, rtol=TOL[dtype],
                                   atol=TOL[dtype])
    assert float(got[1].abs().max()) == 0.0          # every chunk dark
    assert float(got[0].abs().min()) > 0.0


@pytest.mark.parametrize("chunk", [7, 64])
def test_split_ref_soft_cap_and_a_query_before_every_key(chunk):
    """The soft cap through the split, and a prefill row that sees no key
    (its query comes before every key): exactly 0."""
    b, sq, sk, h, kv, d = 2, 8, 40, 4, 2, 32
    q, k, v = _inputs(4, b, sq, sk, h, kv, d)
    q *= 6.0
    q_pos = _positions(b, sq, start=10)
    q_pos[1, 0] = 5
    k_pos = _positions(b, sk, start=6)
    arrays = [q, k, v, q_pos, k_pos]
    got = fa_ref.attention_split_ref(*_torch(arrays, "float32"),
                                     soft_cap=30.0, chunk=chunk)
    for want in _reference(arrays, "float32", soft_cap=30.0):
        np.testing.assert_allclose(_f32(got), want, rtol=2e-5, atol=2e-5)
    assert float(got[1, 0].abs().max()) == 0.0


def _tensor_core_model(q, k, v, q_pos, k_pos, *, p_terms, window=0,
                       soft_cap=0.0, bk=64):
    """The mma_bf16 body's arithmetic in plain PyTorch: bf16 q and k
    multiplied exactly and summed in f32, the f32 scores times 1/sqrt(D)
    (an f32 constant), an online softmax over tiles of bk keys in f32, P
    rounded to bf16 (p_terms 1) or split into P_hi + P_lo (p_terms 2)
    before the f32-accumulated P.V, the sum floored at 1e-30."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     q.reshape(b, sq, kv, h // kv, d).float(), k.float())
    s = s * torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    if soft_cap:
        s = soft_cap * torch.tanh(s / soft_cap)
    ok = (k_pos[:, None, :] <= q_pos[:, :, None]) & (k_pos[:, None, :] >= 0)
    if window:
        ok &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    ok = ok[:, None, None]
    s = torch.where(ok, s, fa_ref.NEG_INF)
    m = torch.full(s.shape[:-1], fa_ref.NEG_INF)
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros(*s.shape[:-1], d)
    for k0 in range(0, sk, bk):
        st, okt = s[..., k0:k0 + bk], ok[..., k0:k0 + bk]
        mn = torch.maximum(m, st.amax(dim=-1))
        corr = torch.exp(m - mn)
        m = mn
        p = torch.where(okt, torch.exp(st - mn[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        p_bf = p.bfloat16().float()
        if p_terms == 2:
            p_bf = p_bf + (p - p_bf).bfloat16().float()
        o = o * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p_bf, v[:, k0:k0 + bk].float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


@pytest.mark.parametrize("p_terms", [1, 2])
@pytest.mark.parametrize("shape", SWEEP)
def test_tensor_core_rounding_model_matches_reference(shape, p_terms):
    arrays, wants = _sweep_case(shape, "bfloat16")
    q, k, v, q_pos, k_pos = _torch(arrays, "bfloat16")
    got = _tensor_core_model(q, k, v, q_pos, k_pos, p_terms=p_terms)
    assert got.dtype == torch.bfloat16
    for want in wants:
        np.testing.assert_allclose(_f32(got), want, rtol=4e-2, atol=4e-2)


def test_tensor_core_rounding_model_masks():
    """The model with a window, the soft cap, empty slots and a row with no
    key, in both P variants, against the reference; the P_hi + P_lo split
    stays closer to the f32-P plain version than one bf16 part."""
    b, sq, sk, h, kv, d = 2, 70, 150, 8, 2, 64
    q, k, v = _inputs(6, b, sq, sk, h, kv, d)
    q *= 3.0
    q_pos = _positions(b, sq, start=80)
    k_pos = _positions(b, sk)
    k_pos[:, -9:] = -1
    k_pos[1] = -1
    arrays = [q, k, v, q_pos, k_pos]
    kw = {"window": 60, "soft_cap": 20.0}
    wants = _reference(arrays, "bfloat16", **kw)
    tq, tk, tv, tqp, tkp = _torch(arrays, "bfloat16")
    plain = _f32(fa_ref.attention_ref(tq, tk, tv, tqp, tkp, **kw))
    off = {}
    for p_terms in (1, 2):
        got = _tensor_core_model(tq, tk, tv, tqp, tkp, p_terms=p_terms, **kw)
        for want in wants:
            np.testing.assert_allclose(_f32(got), want, rtol=4e-2, atol=4e-2)
        assert float(got[1].abs().max()) == 0.0
        off[p_terms] = float(np.mean(_f32(got) != plain))
    assert off[2] < off[1] / 10


@functools.lru_cache(maxsize=None)
def _long_decode():
    """bf16 decode inputs at chip_smoke.py's decode_long shape (B 8, Sk
    8192 with 16 empty trailing slots, H 24, KV 2, D 128) and the plain
    output."""
    b, sk, h, kv, d = 8, 8192, 24, 2, 128
    q, k, v = [torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(3, b, 1, sk, h, kv, d)]
    q_pos = torch.full((b, 1), sk - 17, dtype=torch.int32)
    k_pos = torch.from_numpy(_positions(b, sk))
    k_pos[:, -16:] = -1
    return (q, k, v, q_pos, k_pos), fa_ref.attention_ref(q, k, v, q_pos,
                                                         k_pos)


@pytest.mark.parametrize("dropped", [0, 32, 63])
def test_bf16_step_gate_catches_a_dropped_chunk(dropped):
    """At a long cache a decode's outputs are about as small as the bf16
    tolerance (4e-2): the split's plain version (64 chunks of 128 keys, as
    the kernel takes them) is within 2 bf16 steps of the plain output on
    every row, while the same with chunk ``dropped`` left out of the
    merge is far past 2 steps and yet within 4e-2."""
    (q, k, v, q_pos, k_pos), want = _long_decode()
    tol = TOL["bfloat16"]
    split = fa_ref.attention_split_ref(q, k, v, q_pos, k_pos, chunk=128)
    assert fa_ref.bf16_steps(split, want) <= 2
    k_pos = k_pos.clone()
    k_pos[:, dropped * 128:(dropped + 1) * 128] = -1
    faulty = fa_ref.attention_split_ref(q, k, v, q_pos, k_pos, chunk=128)
    assert fa_ref.bf16_steps(faulty, want) > 20
    np.testing.assert_allclose(_f32(faulty), _f32(want), rtol=tol, atol=tol)


def test_plan_routes_and_chunks():
    """The route of each serving shape (StarCoder2-3B: H 24, KV 2, D 128)
    and the split decode's chunks: enough blocks for the card, never more
    than MAX_SPLITS chunks, and the chunks cover the keys."""
    f32, bf16 = torch.float32, torch.bfloat16
    prefill_q, prefill_k = (8, 1024, 24, 128), (8, 1056, 2, 128)
    decode_q = (8, 1, 24, 128)
    assert fa_ops.plan(prefill_q, prefill_k, f32, 132) == ("fma", 0, 0)
    assert fa_ops.plan(prefill_q, prefill_k, bf16, 132) == \
        ("mma_bf16", 0, 0)
    for d in (40, 48, 96):                           # no mma body for D
        assert fa_ops.plan((8, 1024, 24, d), prefill_k[:3] + (d,), bf16,
                           132) == ("fma", 0, 0)
    for d in fa_ops.TENSOR_CORE_DIMS:
        assert fa_ops.plan((2, 77, 8, d), (2, 90, 2, d), bf16, 132) == \
            ("mma_bf16", 0, 0)
    # decode: 17 chunks of 64 -> 272 blocks on 132 SMs
    assert fa_ops.plan(decode_q, (8, 1056, 2, 128), f32, 132) == \
        ("split_decode", 64, 17)
    assert fa_ops.plan(decode_q, (8, 1056, 2, 128), bf16, 132) == \
        ("split_decode_mma", 64, 17)
    assert fa_ops.plan((8, 1, 24, 40), (8, 1056, 2, 40), bf16, 132) == \
        ("split_decode", 64, 17)                     # no mma body for D
    # a long cache: more chunks, each 128 keys in bf16 once the grid is full
    assert fa_ops.plan(decode_q, (8, 8192, 2, 128), bf16, 132) == \
        ("split_decode_mma", 128, 64)
    assert fa_ops.plan(decode_q, (8, 8192, 2, 128), f32, 132) == \
        ("split_decode", 64, 128)
    # 16 rows a (batch, kv head) still split; 17 do not
    assert fa_ops.plan((1, 2, 16, 64), (1, 50, 2, 64), bf16, 132)[0] == \
        "split_decode_mma"
    assert fa_ops.plan((1, 1, 17, 64), (1, 50, 1, 64), bf16, 132)[0] == \
        "mma_bf16"
    for sk in (1, 31, 64, 65, 1056, 16_385, 40_000, 1_000_003):
        for dtype in (f32, bf16):
            route, chunk, splits = fa_ops.plan((1, 1, 8, 64), (1, sk, 1, 64),
                                               dtype, 132)
            assert route.startswith("split_decode") and chunk % 32 == 0
            assert splits == math.ceil(sk / chunk) <= fa_ops.MAX_SPLITS
            assert (splits - 1) * chunk < sk <= splits * chunk
