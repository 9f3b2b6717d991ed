"""The port on the card: the CUDA kernels against their plain versions,
the server step and trainer rounds (plain, async int8, guarded under
faults) on CUDA against the same on the CPU, and the serving paths of
the dense decoder (every attention call through the flash-attention
kernel) and of the pure-SSM stack (every scan through the ssm_scan
kernel) against the same on the CPU. Marked ``cuda``; each test skips without a card. This file imports
no JAX, so it also runs where only the port is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.bridge import layout_of, tree_map
from repro_torch.configs import paper_lenet5, paper_resnet18
from repro_torch.core import feddpc
from repro_torch.core import projection as proj
from repro_torch.core.api import AlgoConfig, ExecConfig, FederatedTrainer
from repro_torch.core.faults import FaultPlan
from repro_torch.core.runtime import ExponentialRuntime
from repro_torch.ingest.images import (StreamingImageSource,
                                       build_federated_image_data)
from repro_torch.configs.base import get_config
from repro_torch.kernels.feddpc_project import ops, ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.ssm_scan import ref as ss_ref
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.models.vision import init_vision, vision_loss_fn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested against the "
                    "reference in test_torch_feddpc_kernels.py)")
    return torch.device("cuda")


def _case(k, n, zero_prev, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((k, n), dtype=np.float32)
    p = (np.zeros(n, np.float32) if zero_prev
         else rng.standard_normal(n, dtype=np.float32))
    w = rng.standard_normal(n, dtype=np.float32)
    coefs = rng.standard_normal(k, dtype=np.float32)
    scales = (1.0 + np.abs(rng.standard_normal(k))).astype(np.float32)
    return [torch.from_numpy(x) for x in (d, p, w, coefs, scales)]


@pytest.mark.parametrize("k,n", [(1, 37), (3, 1000), (7, 70001),
                                 (10, 1_000_003), (33, 4099)])
@pytest.mark.parametrize("zero_prev", [False, True])
def test_kernels_match_plain_versions(cuda, k, n, zero_prev):
    d, p, w, coefs, scales = [x.to(cuda) for x in _case(k, n, zero_prev)]
    before = [fn.launches for fn in ops.KERNELS]
    got = ops.feddpc_dots(d, p)
    want = ref.dots_ref(d, p)
    # f32 sums in other orders: relative to sqrt(<d,d><p,p>) for the
    # cross term (Cauchy-Schwarz) and to the norms themselves
    scale = torch.stack([torch.sqrt(want[:, 1] * want[:, 2]), want[:, 1],
                         want[:, 2]], -1).clamp(min=1.0)
    assert float(((got - want).abs() / scale).max()) <= 1e-5
    got_w, got_dt = ops.feddpc_batched_epilogue(d, p, w, coefs, scales, 0.3)
    want_w, want_dt = ref.batched_epilogue_ref(d, p, w, coefs, scales, 0.3)
    torch.cuda.synchronize()
    # same element-wise rounding; the mean divides where torch multiplies
    # by 1/K (about one ulp)
    torch.testing.assert_close(got_dt, want_dt, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_w, want_w, rtol=1e-5, atol=1e-5)
    assert [fn.launches - b for fn, b in zip(ops.KERNELS, before)] == \
        [1, 1, 0, 0, 0, 0, 0]


def _offsets(numels):
    return torch.tensor(np.concatenate([[0], np.cumsum(numels)]),
                        dtype=torch.int64)


@functools.lru_cache(maxsize=None)
def _resnet18_offsets():
    params = init_vision(paper_resnet18.CONFIG,
                         torch.Generator().manual_seed(0))
    return layout_of(params).leaf_offsets


def _payload(k, offsets, qdtype, seed):
    """A codec payload: q (k, N) int8 or bf16 codes, qscale/qzero (k, L)."""
    rng = np.random.default_rng(seed)
    n, nleaves = int(offsets[-1]), len(offsets) - 1
    if qdtype == torch.int8:
        q = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    else:
        q = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)
                             ).to(torch.bfloat16)
    qscale = torch.from_numpy(rng.uniform(1e-3, 2e-2, (k, nleaves))
                              .astype(np.float32))
    qzero = torch.from_numpy(rng.standard_normal((k, nleaves),
                                                 dtype=np.float32) * 0.1)
    return q, qscale, qzero


# (K, leaf sizes): leaves shorter than a warp, a boundary inside every
# 2,048-column tile, K = 33 past one shared-memory chunk of rows, and
# ResNet18-GN's real layout (62 leaves, 11,220,132 parameters)
FOLD_CASES = [(1, (5, 37, 3, 2048, 1, 999)), (10, (7,) * 300 + (4099,)),
              (33, (31, 64, 5000, 17)), (10, "resnet18")]


@pytest.mark.parametrize("k,numels", FOLD_CASES)
@pytest.mark.parametrize("qdtype", [torch.int8, torch.bfloat16])
def test_folds_match_plain_versions(cuda, k, numels, qdtype):
    offsets = (_resnet18_offsets() if numels == "resnet18"
               else _offsets(numels))
    n = int(offsets[-1])
    q, qscale, qzero = [x.to(cuda) for x in _payload(k, offsets, qdtype, k)]
    _, p, w, coefs, scales = [x.to(cuda) for x in _case(k, n, False)]
    wgts = torch.linspace(0.3, 1.0, k, device=cuda)
    d = ref.dequant_ref(q, qscale, qzero, offsets)
    before = [fn.launches for fn in ops.KERNELS]
    got = {
        "buffer_fold": ops.feddpc_buffer_fold(d, p, w, coefs, scales, wgts,
                                              0.3),
        "dequant_epilogue": ops.feddpc_dequant_batched_epilogue(
            q, qscale, qzero, offsets, p, w, coefs, scales, 0.3),
        "dequant_fold": ops.feddpc_dequant_buffer_fold(
            q, qscale, qzero, offsets, p, w, coefs, scales, wgts, 0.3)}
    want = {
        "buffer_fold": ref.buffer_fold_ref(d, p, w, coefs, scales, wgts,
                                           0.3),
        "dequant_epilogue": ref.dequant_batched_epilogue_ref(
            q, qscale, qzero, offsets, p, w, coefs, scales, 0.3),
        "dequant_fold": ref.dequant_buffer_fold_ref(
            q, qscale, qzero, offsets, p, w, coefs, scales, wgts, 0.3)}
    torch.cuda.synchronize()
    # the same element-wise rounding (the kernels' _rn intrinsics, the
    # dequant a multiply then an add); the mean divides where torch
    # multiplies by 1/K: about one ulp
    for key in got:
        for a, b in zip(got[key], want[key]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                       msg=key)
    assert [fn.launches - b for fn, b in zip(ops.KERNELS, before)] == \
        [0, 0, 1, 1, 1, 0, 0]


def test_dequant_folds_reject_bad_offsets_on_the_card(cuda):
    offsets = _offsets((10, 20))
    q, qscale, qzero = [x.to(cuda) for x in _payload(2, offsets, torch.int8,
                                                     0)]
    _, p, w, coefs, scales = [x.to(cuda) for x in _case(2, 30, False)]
    with pytest.raises(ValueError, match="leaf_offsets"):
        ops.feddpc_dequant_batched_epilogue(q, qscale, qzero,
                                            offsets.to(cuda), p, w, coefs,
                                            scales, 0.1)
    with pytest.raises(ValueError, match="strictly increasing"):
        ops.feddpc_dequant_batched_epilogue(
            q, qscale, qzero, torch.tensor([0, 31, 30]), p, w, coefs,
            scales, 0.1)


@pytest.mark.parametrize("masked", [False, True])
def test_server_step_on_card_matches_cpu(cuda, masked):
    d, p, w, _, _ = _case(6, 50_001, False, seed=1)
    mask = torch.tensor([True, False, True, True, True, False]) \
        if masked else None
    outs = {}
    for dev in ("cpu", cuda):
        outs[str(dev)] = feddpc.server_step(
            {"delta_prev": p.to(dev)}, w.to(dev), d.to(dev), 0.1, 0.7,
            client_mask=None if mask is None else mask.to(dev))
    (cw, cs, cd), (gw, gs, gd) = outs["cpu"], outs["cuda"]
    torch.testing.assert_close(gw.cpu(), cw, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gs["delta_prev"].cpu(), cs["delta_prev"],
                               rtol=1e-5, atol=1e-6)
    for key in cd:
        if key == "global_dot_prev":
            # <Δ_t, Δ_prev> is 0 up to cancellation (Δ_t is orthogonal to
            # Δ_prev by construction): compare it on the Cauchy-Schwarz
            # scale of its terms, as the dots are compared
            scale = float(cs["delta_prev"].norm() * p.norm())
            assert abs(float(gd[key]) - float(cd[key])) <= 1e-5 * scale
            continue
        torch.testing.assert_close(gd[key].cpu(), cd[key], rtol=1e-4,
                                   atol=1e-5)


def test_trainer_round_on_card_matches_cpu(cuda):
    cfg = paper_lenet5.CONFIG
    data = build_federated_image_data(num_classes=10, num_clients=8,
                                      alpha=0.5, samples_per_class=16,
                                      test_per_class=2, seed=0)
    params = init_vision(cfg, torch.Generator().manual_seed(0))
    losses = {}
    for dev in ("cpu", "cuda"):
        tr = FederatedTrainer(functools.partial(vision_loss_fn, cfg), params,
                              8, StreamingImageSource(data, 16),
                              ExecConfig(rounds=2, clients_per_round=4),
                              algo=AlgoConfig(eta_l=0.02, eta_g=0.02),
                              device=dev)
        before = [fn.launches for fn in ops.KERNELS]
        losses[dev] = [r.train_loss for r in tr.run()]
        added = [fn.launches - b for fn, b in zip(ops.KERNELS, before)]
        assert added == ([2, 2, 0, 0, 0, 0, 0] if dev == "cuda"
                         else [0] * 7)
    # TF32 off: card and CPU differ by conv algorithms and sum orders
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-3)


def test_async_int8_trainer_on_card_matches_cpu(cuda):
    """Buffered-async FedDPC with an int8 uplink and error feedback:
    every fold goes through feddpc_dequant_buffer_fold on the card, and
    the run agrees with the same run on the CPU."""
    cfg = paper_lenet5.CONFIG
    data = build_federated_image_data(num_classes=10, num_clients=8,
                                      alpha=0.5, samples_per_class=16,
                                      test_per_class=2, seed=0)
    params = init_vision(cfg, torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = FederatedTrainer(
            functools.partial(vision_loss_fn, cfg), params, 8,
            StreamingImageSource(data, 16),
            ExecConfig(rounds=3, clients_per_round=4, async_buffer=True,
                       buffer_size=2, async_concurrency=3, codec="int8",
                       codec_ef=True),
            algo=AlgoConfig(eta_l=0.02, eta_g=0.02),
            runtime=ExponentialRuntime(mean=1.0), device=dev)
        before = [fn.launches for fn in ops.KERNELS]
        runs[dev] = tr.run()
        added = [fn.launches - b for fn, b in zip(ops.KERNELS, before)]
        assert added == ([3, 0, 0, 0, 3, 0, 0] if dev == "cuda"
                         else [0] * 7)
    assert [r.staleness_max for r in runs["cuda"]] == \
        [r.staleness_max for r in runs["cpu"]]
    # TF32 off: card and CPU differ by conv algorithms and sum orders
    np.testing.assert_allclose([r.train_loss for r in runs["cuda"]],
                               [r.train_loss for r in runs["cpu"]],
                               atol=1e-3)


def _guard_rows(k, n, seed):
    """(k, n) rows on the CPU: clean, scattered NaN/+-Inf, all NaN, x1e12
    in turn; and p."""
    gen = torch.Generator().manual_seed(seed)
    d = torch.randn((k, n), generator=gen)
    for j in range(k):
        if j % 4 == 1:
            at = torch.randperm(n, generator=gen)[:5]
            d[j, at] = torch.tensor([float("nan"), float("inf"),
                                     float("-inf"), float("nan"),
                                     float("inf")])[:len(at)]
        elif j % 4 == 2:
            d[j] = float("nan")
        elif j % 4 == 3:
            d[j] *= 1e12
    return d, torch.randn(n, generator=gen)


@pytest.mark.parametrize("k,n", [(1, 37), (10, 1_000_003), (33, 4099),
                                 (10, 11_220_132)])
@pytest.mark.parametrize("zero_prev", [False, True])
def test_guard_dots_match_plain_version(cuda, k, n, zero_prev):
    """With and without p; the non-finite count exactly."""
    d, p = _guard_rows(k, n, k)
    if zero_prev:
        p.zero_()
    d, p = d.to(cuda), p.to(cuda)
    before = [fn.launches for fn in ops.KERNELS]
    for pv in (p, None):
        got = ops.feddpc_guard_dots(d, pv)
        want = ref.guard_dots_ref(d, pv)
        torch.cuda.synchronize()
        assert torch.equal(got[:, 3], want[:, 3])
        assert torch.isfinite(got).all()
        scale = torch.stack([torch.sqrt(want[:, 1] * want[:, 2]),
                             want[:, 1], want[:, 2]], -1).clamp(min=1.0)
        assert float(((got[:, :3] - want[:, :3]).abs() / scale).max()) \
            <= 1e-5
        if pv is None:
            assert bool((got[:, [0, 2]] == 0).all())
    assert [fn.launches - b for fn, b in zip(ops.KERNELS, before)] == \
        [0, 0, 0, 0, 0, 2, 0]


@pytest.mark.parametrize("n", [37, 1_000_003, 11_220_132])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zero_prev", [False, True])
def test_fused_epilogue_matches_plain_version(cuda, n, dtype, zero_prev):
    d, p, _, coefs, scales = [x.to(cuda) for x in _case(1, n, zero_prev)]
    d = d[0].to(dtype)
    before = [fn.launches for fn in ops.KERNELS]
    got = ops.feddpc_fused_epilogue(d, p, coefs, scales)
    want = ref.epilogue_ref(d, p, coefs, scales)
    scaled, _ = proj.project_and_scale(d, p, 0.8, use_kernel=True)
    coef, scale, _ = proj.projection_scalars(d, p, 0.8)
    torch.cuda.synchronize()
    assert got.dtype == dtype and scaled.dtype == dtype
    # the same three roundings in f32 (the kernel's _rn intrinsics); the
    # cast to bf16 rounds identical f32 values
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(scaled, ref.epilogue_ref(d, p, coef, scale),
                               rtol=1e-6, atol=1e-6)
    assert [fn.launches - b for fn, b in zip(ops.KERNELS, before)] == \
        [0, 0, 0, 0, 0, 0, 2]


def test_guard_and_epilogue_reject_bad_inputs_on_the_card(cuda):
    d, p, _, coefs, scales = [x.to(cuda) for x in _case(3, 100, False)]
    with pytest.raises(ValueError, match="p is on cpu"):
        ops.feddpc_guard_dots(d, p.cpu())
    with pytest.raises(TypeError, match="float32"):
        ops.feddpc_guard_dots(d.half())
    with pytest.raises(ValueError, match="contiguous"):
        ops.feddpc_guard_dots(d.t().contiguous().t())
    with pytest.raises(ValueError, match="coef is on cpu"):
        ops.feddpc_fused_epilogue(d[0], p, coefs[0].cpu(), scales[0])
    with pytest.raises(ValueError, match="p must be"):
        ops.feddpc_fused_epilogue(d[0], p[:-1], coefs[0], scales[0])
    with pytest.raises(ValueError, match="contiguous"):
        ops.feddpc_fused_epilogue(d[:, 0], p[:3], coefs[0], scales[0])


def test_guarded_faulted_trainer_on_card_matches_cpu(cuda):
    """Sync FedDPC with the guard, NaN and exploded deltas and a round
    deadline: the guard's reduction runs through feddpc_guard_dots once
    per round on the card, the same rows quarantine and drop on both
    devices, and the losses agree."""
    cfg = paper_lenet5.CONFIG
    data = build_federated_image_data(num_classes=10, num_clients=8,
                                      alpha=0.5, samples_per_class=16,
                                      test_per_class=2, seed=0)
    params = init_vision(cfg, torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = FederatedTrainer(
            functools.partial(vision_loss_fn, cfg), params, 8,
            StreamingImageSource(data, 16),
            ExecConfig(rounds=3, clients_per_round=4, guard=True,
                       guard_min_history=2, round_deadline=1.5),
            algo=AlgoConfig(eta_l=0.02, eta_g=0.02),
            runtime=ExponentialRuntime(mean=1.0),
            fault_plan=FaultPlan.seeded(0, nan_rate=0.3, explode_rate=0.3,
                                        explode_rounds=(1, 2)),
            device=dev)
        before = [fn.launches for fn in ops.KERNELS]
        runs[dev] = tr.run()
        added = [fn.launches - b for fn, b in zip(ops.KERNELS, before)]
        assert added == ([3, 3, 0, 0, 0, 3, 0] if dev == "cuda"
                         else [0] * 7)
    for key in ("quarantined", "clipped", "deadline_dropped",
                "comm_bytes_up"):
        assert [getattr(r, key) for r in runs["cuda"]] == \
            [getattr(r, key) for r in runs["cpu"]], key
    assert sum(r.quarantined for r in runs["cpu"]) > 0
    # TF32 off: card and CPU differ by conv algorithms and sum orders
    np.testing.assert_allclose([r.train_loss for r in runs["cuda"]],
                               [r.train_loss for r in runs["cpu"]],
                               atol=1e-3)


# ---- flash attention and the serving path ----

# (b, sq, sk, h, kv, d, window, soft_cap, empty trailing slots[, slots
# rolled as a ring]): prefill and decode at StarCoder2's heads (G = 12),
# ragged tails, a ring-cache decode with a window, the soft cap, D = 32
# and D = 256; then decodes (the split route) at Sk 64, 1056 and 8192, a
# ring decode whose window leaves most splits dark, and prefills at D 32,
# 64, 128 and 256 with Sq not a multiple of 16 (bf16: the tensor cores)
FA_CASES = [(2, 100, 132, 24, 2, 128, 0, 0.0, 32),
            (8, 1, 1056, 24, 2, 128, 0, 0.0, 32),
            (1, 100, 300, 8, 2, 64, 0, 0.0, 0),
            (2, 1, 300, 16, 2, 128, 128, 0.0, 7),
            (1, 77, 77, 4, 2, 64, 0, 30.0, 0),
            (2, 33, 40, 4, 4, 32, 16, 0.0, 3),
            (1, 20, 50, 2, 1, 256, 0, 0.0, 5),
            (8, 1, 64, 24, 2, 128, 0, 0.0, 0),
            (8, 1, 1056, 24, 2, 128, 0, 0.0, 0),
            (8, 1, 8192, 24, 2, 128, 0, 0.0, 16),
            (4, 1, 8192, 24, 2, 128, 128, 0.0, 0, 3001),
            (2, 77, 90, 8, 2, 32, 0, 0.0, 3),
            (2, 77, 90, 8, 2, 64, 0, 0.0, 3),
            (2, 77, 90, 8, 2, 128, 0, 0.0, 3),
            (2, 77, 90, 8, 2, 256, 0, 0.0, 3)]


def _fa_inputs(case, dtype, device):
    """q, k, v (numpy draws of seed 0, cast) and int32 positions: queries
    at the last Sq positions, keys at 0 .. Sk - 1 with ``empty`` trailing
    slots at -1 (then rolled as a ring), and a last batch row (when B > 1)
    with every slot empty."""
    b, sq, sk, h, kv, d, window, soft_cap, empty, *roll = case
    rng = np.random.default_rng(0)
    q, k, v = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                ).to(device, dtype)
               for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]
    if soft_cap:
        q = q * 6
    q_pos = torch.arange(sk - sq, sk, dtype=torch.int32,
                         device=device)[None].expand(b, sq).contiguous()
    k_pos = torch.arange(sk, dtype=torch.int32, device=device)[None].repeat(
        b, 1)
    if empty:
        k_pos[:, sk - empty:] = -1
    if roll:
        k_pos = torch.roll(k_pos, roll[0], dims=1)
    if b > 1:
        k_pos[-1] = -1                       # a batch row with no key
    return q, k, v, q_pos, k_pos


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_version(cuda, case, dtype):
    b, sq, sk, h, kv, d, window, soft_cap = case[:8]
    q, k, v, q_pos, k_pos = _fa_inputs(case, dtype, cuda)
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v, q_pos, k_pos, window=window,
                                 soft_cap=soft_cap)
    want = fa_ref.attention_ref(q, k, v, q_pos, k_pos, window=window,
                                soft_cap=soft_cap)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    # the reference's kernel tolerances (tests/test_kernels.py)
    tol = 2e-5 if dtype == torch.float32 else 4e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        # and every row within 2 bf16 steps at its own scale (4e-2 is as
        # large as a decode's outputs)
        assert fa_ref.bf16_steps(got, want) <= 2
    if b > 1:
        assert bool((got[-1] == 0).all())


# the kernel's names in a profile, by route (ops.ROUTES)
FA_KERNELS = {"fma": "fa_fwd_kernel", "mma_bf16": "fa_mma_kernel",
              "split_decode": "fa_split_kernel",
              "split_decode_mma": "fa_split_mma_kernel"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_is_bitwise_deterministic(cuda, dtype):
    """The split decode merges its chunks in a fixed order: two calls at
    StarCoder2's decode shape, and at a long cache, are bitwise equal."""
    for case in ((8, 1, 1056, 24, 2, 128, 0, 0.0, 16),
                 (8, 1, 8192, 24, 2, 128, 0, 0.0, 16)):
        args = _fa_inputs(case, dtype, cuda)
        assert fa_ops.plan(args[0].shape, args[1].shape, dtype,
                           fa_ops._num_sms(cuda.index or 0))[0].startswith(
            "split_decode")
        first = fa_ops.flash_attention(*args)
        second = fa_ops.flash_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_call_is_one_launch_of_one_kernel(cuda, dtype):
    """Prefill and decode: each call adds 1 to ``launches`` and the
    profile holds exactly one flash kernel per call, the one of the
    call's route."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for case in ((2, 100, 132, 24, 2, 128, 0, 0.0, 32),
                 (8, 1, 1056, 24, 2, 128, 0, 0.0, 32)):
        args = _fa_inputs(case, dtype, cuda)
        route = fa_ops.plan(args[0].shape, args[1].shape, dtype,
                            fa_ops._num_sms(cuda.index or 0))[0]
        fa_ops.flash_attention(*args)                  # warm
        torch.cuda.synchronize()
        before = fa_ops.flash_attention.launches
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                fa_ops.flash_attention(*args)
            torch.cuda.synchronize()
        assert fa_ops.flash_attention.launches == before + 3
        names = [e.key for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(n in e.key for n in FA_KERNELS.values())]
        assert len(names) == 3 and all(
            FA_KERNELS[route] + "I" in n or FA_KERNELS[route] + "<" in n
            for n in names), names


def test_split_decode_never_waits_for_the_card(cuda):
    """The split route's first call on a new stream (scratch and arrival
    counters allocated there) queues its work without a sync."""
    args = _fa_inputs((8, 1, 1056, 24, 2, 128, 0, 0.0, 16), torch.bfloat16,
                      cuda)
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(stream):
            got = fa_ops.flash_attention(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    want = fa_ref.attention_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=4e-2,
                               atol=4e-2)
    assert fa_ref.bf16_steps(got, want) <= 2


def test_flash_attention_rejects_bad_inputs_on_the_card(cuda):
    q = torch.zeros(1, 4, 4, 30, device=cuda)       # D not a multiple of 4
    k = torch.zeros(1, 6, 2, 30, device=cuda)
    qp = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    kp = torch.zeros(1, 6, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, k, qp, kp)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q[..., :28], k[..., :28], k[..., :28], qp,
                               kp.cpu())


def _teacher_forced(cfg, params, prompts, steps, device, dtype):
    """Prefill, then ``steps`` decode steps fed the tokens 0, 1, ...:
    the logits of each, stacked (1 + steps, B, V) on the CPU."""
    b, s = prompts.shape
    states = tf.init_states(cfg, b, s + steps, dtype, device)
    params = tree_map(lambda t: t.to(device), params)
    logits, states, _ = tf.lm_forward(cfg, params, prompts.to(device),
                                      states=states, logits_slice_last=True)
    out = [logits[:, -1]]
    for i in range(steps):
        tok = torch.full((b, 1), i, dtype=torch.int64, device=device)
        pos = torch.full((b, 1), s + i, dtype=torch.int32, device=device)
        logits, states, _ = tf.lm_forward(cfg, params, tok, positions=pos,
                                          states=states,
                                          logits_slice_last=True)
        out.append(logits[:, -1])
    return torch.stack(out).float().cpu()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serve_on_card_matches_cpu(cuda, dtype):
    """StarCoder2 SMOKE from the same params and prompts on the card and
    on the CPU: prefill and 4 teacher-forced decode steps agree, and the
    card launches the kernel once per layer and step."""
    cfg = get_config("starcoder2-3b", smoke=True)
    params = tf.init_lm(cfg, torch.Generator().manual_seed(0), dtype)
    prompts = torch.randint(0, cfg.vocab_size, (3, 20),
                            generator=torch.Generator().manual_seed(1))
    before = fa_ops.flash_attention.launches
    got = _teacher_forced(cfg, params, prompts, 4, cuda, dtype)
    assert fa_ops.flash_attention.launches - before == cfg.num_layers * 5
    want = _teacher_forced(cfg, params, prompts, 4, "cpu", dtype)
    # f32: matmul and attention sums in other orders; bf16: other
    # rounding points of bf16 activations through two layers
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    before = fa_ops.flash_attention.launches
    tokens, stats = serve.serve_lm(cfg, 3, 20, 6, device="cuda", dtype=dtype)
    assert fa_ops.flash_attention.launches - before == cfg.num_layers * 6
    assert tokens.shape == (3, 6) and stats["tok_per_s"] > 0


def test_decode_step_never_waits_for_the_card(cuda):
    """A decode step queues its work and returns: no call on the path
    synchronizes with the card."""
    cfg = get_config("starcoder2-3b", smoke=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = tf.init_lm(cfg, gen, torch.float32)
    states = tf.init_states(cfg, 2, 9, torch.float32, cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen,
                            device=cuda)
    _, states, _ = tf.lm_forward(cfg, params, prompts, states=states)
    tok = torch.zeros((2, 1), dtype=torch.int64, device=cuda)
    pos = torch.full((2, 1), 8, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tf.lm_forward(cfg, params, tok, positions=pos, states=states)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# ---- the selective scan and the pure-SSM serving path ----

# (B, S, D_in, N, with h0): the smoke's prefill, continuation and decode
# shapes at a narrower width, the reference's ragged sweep shapes, N at
# the kernel's limit, and a decode step (S = 1) at the decode kernel's
# other instances (N <= 4: one lane a channel; N = 32: eight)
SSM_CASES = [(2, 300, 1024, 16, False), (2, 100, 1024, 16, True),
             (8, 1, 8192, 16, True), (2, 100, 96, 8, False),
             (1, 17, 64, 4, False), (1, 70, 200, 32, True),
             (2, 1, 200, 32, True), (2, 1, 64, 4, True)]


def _ssm_inputs(b, s, d_in, n, with_h0, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape,
                                                    dtype=np.float32))
    u = f32(b, s, d_in).to(dtype)
    dt = torch.nn.functional.softplus(f32(b, s, d_in)) * 0.1
    bm, cm = f32(b, s, n), f32(b, s, n)
    a = -torch.exp(f32(d_in, n) * 0.3)
    dsk = f32(d_in)
    h0 = f32(b, d_in, n) if with_h0 else None
    return [None if t is None else t.to(device)
            for t in (u, dt, bm, cm, a, dsk, h0)]


@pytest.mark.parametrize("case", SSM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_matches_plain_version(cuda, case, dtype):
    args = _ssm_inputs(*case, dtype, cuda)
    before = ss_ops.ssm_scan.launches
    y, h = ss_ops.ssm_scan(*args)
    want_y, want_h = ss_ref.ssm_scan_ref(*args)
    torch.cuda.synchronize()
    assert ss_ops.ssm_scan.launches == before + 1
    assert y.dtype == dtype and y.shape == args[0].shape
    # the reference's kernel tolerances (tests/test_kernels.py)
    tol = 2e-4 if dtype == torch.float32 else 4e-2
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, want_h, rtol=2e-4, atol=2e-4)
    # and closer still: the kernel rounds step for step as the plain
    # version does (no FMA contraction, the same tree over the states)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


def _fused_inputs(b, s, d_in, dtype, device, seed=1):
    """x_proj's raw dt rows times W_dt, dt's bias (near dt_proj's -4.6)
    and the gate's z."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape,
                                                    dtype=np.float32))
    raw = f32(b, s, d_in) * 2 + 4.0
    bias = f32(d_in) * 0.5 - 4.6
    z = (f32(b, s, d_in) * 2).to(dtype)
    return raw.to(device), bias.to(device), z.to(device)


@pytest.mark.parametrize("case", SSM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_fused_matches_plain_version(cuda, case, dtype):
    """dt's bias and softplus and the gate by z inside the launch, bit for
    bit against the plain version's eager ops on the card."""
    u, _, bm, cm, a, dsk, h0 = _ssm_inputs(*case, dtype, cuda)
    raw, bias, z = _fused_inputs(case[0], case[1], case[2], dtype, cuda)
    kw = {"dt_bias": bias, "dt_softplus": True, "z": z}
    before = ss_ops.ssm_scan.launches
    y, h = ss_ops.ssm_scan(u, raw, bm, cm, a, dsk, h0, **kw)
    want_y, want_h = ss_ref.ssm_scan_ref(u, raw, bm, cm, a, dsk, h0, **kw)
    torch.cuda.synchronize()
    assert ss_ops.ssm_scan.launches == before + 1
    assert y.dtype == dtype and y.shape == u.shape
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


def test_ssm_scan_fused_reads_unaligned_rows_on_the_card(cuda):
    """z as the model hands it (a slice of in_proj's output), b and c
    slices at odd offsets and an odd D_in in bf16: the element-by-element
    staging path, still bit for bit."""
    for d_in, s, h0_on in ((37, 21, False), (37, 1, True)):
        u, _, _, _, a, dsk, h0 = _ssm_inputs(2, s, d_in, 5, h0_on,
                                             torch.bfloat16, cuda)
        raw, bias, _ = _fused_inputs(2, s, d_in, torch.bfloat16, cuda)
        xz = torch.randn(2, s, 2 * d_in, device=cuda).to(torch.bfloat16)
        proj = torch.randn(2, s, 3 + 10, device=cuda)
        bm, cm = proj[..., 3:8], proj[..., 8:]
        kw = {"dt_bias": bias, "dt_softplus": True, "z": xz[..., d_in:]}
        y, h = ss_ops.ssm_scan(u, raw, bm, cm, a, dsk, h0, **kw)
        want_y, want_h = ss_ref.ssm_scan_ref(u, raw, bm, cm, a, dsk, h0,
                                             **kw)
        torch.cuda.synchronize()
        assert torch.equal(y, want_y) and torch.equal(h, want_h)


def test_ssm_scan_takes_strided_b_and_c_on_the_card(cuda):
    """b and c as the model hands them: slices of one projection."""
    u, dt, _, _, a, dsk, h0 = _ssm_inputs(2, 40, 256, 16, True,
                                          torch.float32, cuda)
    proj = torch.randn(2, 40, 8 + 32, device=cuda)
    bm, cm = proj[..., 8:24], proj[..., 24:]
    y, h = ss_ops.ssm_scan(u, dt, bm, cm, a, dsk, h0)
    want_y, want_h = ss_ref.ssm_scan_ref(u, dt, bm, cm, a, dsk, h0)
    torch.testing.assert_close(y, want_y, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, want_h, rtol=2e-4, atol=2e-4)


def test_ssm_scan_rejects_bad_inputs_on_the_card(cuda):
    u, dt, bm, cm, a, dsk, h0 = _ssm_inputs(1, 4, 64, 33, True,
                                            torch.float32, cuda)
    with pytest.raises(ValueError, match="N up to 32"):
        ss_ops.ssm_scan(u, dt, bm, cm, a, dsk, h0)
    with pytest.raises(ValueError, match="on cpu"):
        ss_ops.ssm_scan(u, dt, bm, cm, a.cpu(), dsk)
    with pytest.raises(TypeError, match="b must be float32"):
        ss_ops.ssm_scan(u, dt, bm.to(torch.bfloat16), cm, a, dsk)


def _ssm_teacher_forced(cfg, params, prompts, steps, device):
    """Prefill, then ``steps`` decode steps fed the tokens 0, 1, ...:
    the logits of each, stacked (1 + steps, B, V) on the CPU."""
    b, s = prompts.shape
    states = tf.init_states(cfg, b, s + steps, params["embed"].dtype, device)
    params = tree_map(lambda t: t.to(device), params)
    logits, states, _ = tf.lm_forward(cfg, params, prompts.to(device),
                                      states=states, logits_slice_last=True)
    out = [logits[:, -1]]
    for i in range(steps):
        tok = torch.full((b, 1), i, dtype=torch.int64, device=device)
        logits, states, _ = tf.lm_forward(cfg, params, tok, states=states,
                                          logits_slice_last=True)
        out.append(logits[:, -1])
    return torch.stack(out).float().cpu()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serve_ssm_on_card_matches_cpu(cuda, dtype):
    """Falcon-Mamba SMOKE from the same params and prompts on the card and
    on the CPU: prefill and 4 teacher-forced decode steps agree, and the
    card launches the scan kernel once per layer and forward."""
    cfg = get_config("falcon-mamba-7b", smoke=True)
    params = tf.init_lm(cfg, torch.Generator().manual_seed(0), dtype)
    prompts = torch.randint(0, cfg.vocab_size, (3, 20),
                            generator=torch.Generator().manual_seed(1))
    before = (ss_ops.ssm_scan.launches, fa_ops.flash_attention.launches)
    got = _ssm_teacher_forced(cfg, params, prompts, 4, cuda)
    assert (ss_ops.ssm_scan.launches - before[0],
            fa_ops.flash_attention.launches - before[1]) == \
        (cfg.num_layers * 5, 0)
    want = _ssm_teacher_forced(cfg, params, prompts, 4, "cpu")
    # f32: matmul and scan sums in other orders; bf16: other rounding
    # points of bf16 activations through two layers
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    before = ss_ops.ssm_scan.launches
    tokens, stats = serve.serve_lm(cfg, 3, 20, 6, device="cuda", dtype=dtype)
    assert ss_ops.ssm_scan.launches - before == cfg.num_layers * 6
    assert tokens.shape == (3, 6) and stats["tok_per_s"] > 0
