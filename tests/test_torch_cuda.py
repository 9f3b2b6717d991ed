"""The port on the card: the CUDA kernels against their plain versions,
the server step, every other server rule's step and trainer rounds
(plain, async int8, guarded under faults, int8_sr) on CUDA against the
same on the CPU, the int8_sr encode kernel bit for bit against its plain
version, and the serving paths of
the dense decoder (every attention call through the flash-attention
kernel) and of the pure-SSM stack (every scan through the ssm_scan
kernel) against the same on the CPU, the MoE, MLA and hybrid SMOKE
decoders and the encoder-decoder against the CPU, checkpoints saved on
the card restored on the card and on the CPU, and the LM training route
(no serving kernel: neither has a backward) against the CPU. Marked ``cuda``; each test skips without a card. This file imports
no JAX, so it also runs where only the port is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.bridge import layout_of, tree_leaves, tree_map
from repro_torch.configs import paper_lenet5, paper_resnet18
from repro_torch.core import baselines, feddpc, jax_prng
from repro_torch.core import projection as proj
from repro_torch.core.api import AlgoConfig, ExecConfig, FederatedTrainer
from repro_torch.core.faults import FaultPlan
from repro_torch.core.runtime import ExponentialRuntime
from repro_torch.ingest.images import (StreamingImageSource,
                                       build_federated_image_data)
from repro_torch.configs.base import get_config
from repro_torch.kernels.feddpc_project import ops, ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.int8_sr import ops as sr_ops
from repro_torch.kernels.int8_sr import ref as sr_ref
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
    params = init_vision(paper_resnet18.CONFIG, jax_prng.PRNGKey(0))
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
# ResNet18-GN's real layout (62 leaves, 11,220,132 parameters); for the
# dequant folds' 16-byte payload loads: N < 16, N = 1 mod 16 with K = 17
# (the rows' byte shifts take every residue), N a multiple of 16 (every
# row aligned), and leaves of 1-15 elements (a boundary in every word)
FOLD_CASES = [(1, (5, 37, 3, 2048, 1, 999)), (10, (7,) * 300 + (4099,)),
              (33, (31, 64, 5000, 17)), (10, "resnet18"), (3, (5,)),
              (17, (6400, 9601)), (4, (16000,)),
              (5, tuple(range(1, 16)) * 20)]


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


@pytest.mark.parametrize("qdtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("at", [1, 3])
def test_dequant_folds_read_an_offset_view_in_place(cuda, qdtype, at):
    """q a contiguous view at an odd storage offset of a larger buffer
    whose other elements hold extreme codes: the folds read none of them
    and agree bitwise with the same folds on a fresh copy of q."""
    k, offsets = 5, _offsets((1, 15, 2, 7, 3000, 1, 12))
    n = int(offsets[-1])
    q, qscale, qzero = [x.to(cuda) for x in _payload(k, offsets, qdtype, 7)]
    big = torch.full((k * n + at + 29,), 127 if qdtype == torch.int8
                     else 1e30, dtype=qdtype, device=cuda)
    view = big[at:at + k * n].view(k, n)
    view.copy_(q)
    _, p, w, coefs, scales = [x.to(cuda) for x in _case(k, n, False)]
    wgts = torch.linspace(0.3, 1.0, k, device=cuda)
    for name, extra in (("feddpc_dequant_batched_epilogue", ()),
                        ("feddpc_dequant_buffer_fold", (wgts,))):
        fold = getattr(ops, name)
        got = fold(view, qscale, qzero, offsets, p, w, coefs, scales,
                   *extra, 0.3)
        fresh = fold(view.clone(), qscale, qzero, offsets, p, w, coefs,
                     scales, *extra, 0.3)
        plain = getattr(ref, f"{name[7:]}_ref")(
            q, qscale, qzero, offsets, p, w, coefs, scales, *extra, 0.3)
        torch.cuda.synchronize()
        for a, b, c in zip(got, fresh, plain):
            assert torch.equal(a, b), name
            torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5, msg=name)


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


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("edges", [2, 3])
def test_edge_folds_read_row_slices_on_card(cuda, edges, codec):
    """edges=E folds each edge's rows with one launch on a row slice of
    the (K, N) stack (or of the int8 payload): views at a storage offset
    (N odd, so rows start off 16-byte boundaries) the wrappers take in
    place; one dots and E folds a step, as on the CPU."""
    from repro_torch.codec import make_codec
    d, p, w, _, _ = _case(6, 50_001, False, seed=2)
    offsets = torch.tensor([0, 7, 20_000, 50_001])
    mask = torch.tensor([True, False, True, True, True, False])
    outs = {}
    for dev in ("cpu", cuda):
        payload = None
        dd = d.to(dev)
        if codec is not None:
            c = make_codec(codec)
            payload = c.encode_cohort(dd, offsets)
            dd = c.decode_cohort(payload, offsets)
        ops.reset_launches()
        outs[str(dev)] = feddpc.server_step(
            {"delta_prev": p.to(dev)}, w.to(dev), dd, 0.1, 0.7,
            client_mask=mask.to(dev), encoded=payload,
            leaf_offsets=offsets, edges=edges)
    fold = (ops.feddpc_batched_epilogue if codec is None
            else ops.feddpc_dequant_batched_epilogue)
    assert (ops.feddpc_dots.launches, fold.launches) == (1, edges)
    (cw, cs, _), (gw, gs, _) = outs["cpu"], outs["cuda"]
    torch.testing.assert_close(gw.cpu(), cw, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gs["delta_prev"].cpu(), cs["delta_prev"],
                               rtol=1e-5, atol=1e-6)


# FedDPC kernel launches of one step of each rule on the card, in
# ops.KERNELS order (dots, batched epilogue, buffer fold, ...)
RULE_LAUNCHES = {"feddpc_noscale": [1, 1, 0, 0, 0, 0, 0],
                 "feddpc_m": [1, 1, 0, 0, 0, 0, 0]}


@pytest.mark.parametrize("name", [n for n in baselines.ALGORITHM_NAMES
                                  if n not in ("feddpc", "fedavg")])
def test_rule_step_on_card_matches_cpu(cuda, name):
    """Two masked steps of each rule (masked rows at ID_SENTINEL): the
    card's params and state (FedVARP's table included) against the
    CPU's; the FedDPC family through its kernels, one dots and one
    epilogue a step, the others through none."""
    from repro_torch.core.round import ID_SENTINEL
    d, p, w, _, _ = _case(6, 50_001, False, seed=1)
    mask = torch.tensor([True, False, True, True, True, False])
    ids = torch.tensor([3, ID_SENTINEL, 7, 1, 0, ID_SENTINEL],
                       dtype=torch.int32)
    outs = {}
    for dev in ("cpu", "cuda"):
        algo = baselines.make_algorithm(name)
        params, state = w.to(dev), algo.init(w.to(dev), 12)
        state["delta_prev"] = p.to(dev)
        before = [fn.launches for fn in ops.KERNELS]
        for step in range(2):
            params, state, _ = algo.step(
                state, params, (d * (1 + step)).to(dev), ids.to(dev), 0.1,
                step, client_mask=mask.to(dev))
        added = [fn.launches - b for fn, b in zip(ops.KERNELS, before)]
        want = [2 * n for n in RULE_LAUNCHES.get(name, [0] * 7)]
        assert added == (want if dev == "cuda" else [0] * 7)
        outs[dev] = params, state
    (cw, cs), (gw, gs) = outs["cpu"], outs["cuda"]
    torch.testing.assert_close(gw.cpu(), cw, rtol=1e-5, atol=1e-6)
    assert set(gs) == set(cs)
    for key in cs:
        assert gs[key].device.type == "cuda", key
        torch.testing.assert_close(gs[key].cpu(), cs[key], rtol=1e-5,
                                   atol=1e-6)


def test_trainer_round_on_card_matches_cpu(cuda):
    cfg = paper_lenet5.CONFIG
    data = build_federated_image_data(num_classes=10, num_clients=8,
                                      alpha=0.5, samples_per_class=16,
                                      test_per_class=2, seed=0)
    params = init_vision(cfg, jax_prng.PRNGKey(0))
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



@pytest.mark.parametrize("layout,k", [("resnet18", 1), ("resnet18", 10),
                                      ("ragged", 3), ("ragged", 33)])
@pytest.mark.parametrize("partitionable", [True, False])
def test_int8_sr_kernel_matches_plain_version(cuda, layout, k,
                                              partitionable):
    """Codes bit for bit: the kernel and ref.py draw the same threefry
    bits and round the same f32 steps; rows 0 and 1 (K > 2) hold a NaN
    and are all zero (unit scale), as the codec hands them over."""
    offsets = (_resnet18_offsets() if layout == "resnet18"
               else _offsets((5, 31, 1, 17, 2048, 7, 99_991)))
    n, nleaves = int(offsets[-1]), offsets.numel() - 1
    gen = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn((k, n), generator=gen, device=cuda) * 0.01
    scale = torch.rand((k, nleaves), generator=gen, device=cuda) * 1e-4
    if k > 2:
        x[0, 7] = float("nan")
        x[1] = 0.0
        scale[0] = float("nan")
        scale[1] = 1.0
    keys = np.random.default_rng(k).integers(0, 2 ** 32, (nleaves, 2),
                                             dtype=np.uint32)
    before = sr_ops.int8_sr_quantize.launches
    got = sr_ops.int8_sr_quantize(x, scale, offsets, keys, partitionable)
    want = sr_ref.int8_sr_quantize_ref(
        x, scale, offsets, torch.from_numpy(keys.astype(np.int64)),
        partitionable)
    torch.cuda.synchronize()
    assert sr_ops.int8_sr_quantize.launches - before == 1
    assert got.dtype == torch.int8 and torch.equal(got, want)


@pytest.mark.parametrize("model_rank", [None, 0, 1])
@pytest.mark.parametrize("partitionable", [True, False])
def test_int8_sr_kernel_blocks_match_plain_version(cuda, model_rank,
                                                   partitionable):
    """A rank's block, bit for bit against ref.py: rows 3-5 of a 6-row
    stack (row0, rows_total), and on a (2 x 2) mesh model rank 0's or 1's
    shard of the leaves (leaf_blocks; a (7, 9) leaf that no dim of
    2 divides is rank 0's alone)."""
    from repro_torch.sharding.layout import ShardLayout
    tree = {"conv": np.zeros((3, 3, 16, 32), np.float32),
            "b": np.zeros(32, np.float32), "odd": np.zeros((7, 9), np.float32),
            "w": np.zeros((64, 48), np.float32)}
    layout = layout_of(tree)
    offsets, block = layout.leaf_offsets, {}
    n = layout.size
    if model_rank is not None:
        shards = ShardLayout.from_sizes(layout, {"clients": 2, "model": 2})
        offsets = shards.offsets(model_rank)
        n = shards.sizes[model_rank]
        block = {"leaf_blocks": shards.leaf_blocks(model_rank)}
    nleaves = offsets.numel() - 1
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((3, n), generator=gen, device=cuda) * 0.01
    scale = torch.rand((3, nleaves), generator=gen, device=cuda) * 1e-4
    keys = np.random.default_rng(5).integers(0, 2 ** 32, (nleaves, 2),
                                             dtype=np.uint32)
    got = sr_ops.int8_sr_quantize(x, scale, offsets, keys, partitionable,
                                  row0=3, rows_total=6, **block)
    want = sr_ref.int8_sr_quantize_ref(
        x, scale, offsets, torch.from_numpy(keys.astype(np.int64)),
        partitionable, 3, 6, block.get("leaf_blocks"))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_int8_sr_trainer_on_card_matches_cpu(cuda):
    """Sync FedDPC with int8_sr: one int8_sr launch and one dequant fold a
    round on the card; losses within the card-vs-CPU gate."""
    cfg = paper_lenet5.CONFIG
    data = build_federated_image_data(num_classes=10, num_clients=8,
                                      alpha=0.5, samples_per_class=16,
                                      test_per_class=2, seed=0)
    params = init_vision(cfg, jax_prng.PRNGKey(0))
    losses = {}
    for dev in ("cpu", "cuda"):
        tr = FederatedTrainer(functools.partial(vision_loss_fn, cfg), params,
                              8, StreamingImageSource(data, 16),
                              ExecConfig(rounds=2, clients_per_round=4,
                                         codec="int8_sr"),
                              algo=AlgoConfig(eta_l=0.02, eta_g=0.02),
                              device=dev)
        before = (sr_ops.int8_sr_quantize.launches,
                  ops.feddpc_dequant_batched_epilogue.launches)
        with tr:
            losses[dev] = [r.train_loss for r in tr.run()]
        added = (sr_ops.int8_sr_quantize.launches - before[0],
                 ops.feddpc_dequant_batched_epilogue.launches - before[1])
        assert added == ((2, 2) if dev == "cuda" else (0, 0))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-3)

def _fedvarp_adam_trainer(data, params, device, resume_from=None):
    from repro_torch.core.samplers import MarkovSampler
    args = (functools.partial(vision_loss_fn, paper_lenet5.CONFIG), params,
            8, StreamingImageSource(data, 16),
            ExecConfig(rounds=4, clients_per_round=4, server_opt="fedadam"))
    kw = dict(algo=AlgoConfig(name="fedvarp", eta_l=0.02, eta_g=0.02),
              sampler=MarkovSampler(8, 4, p_on=0.5, p_off=0.5),
              device=device)
    if resume_from is not None:
        return FederatedTrainer.resume(resume_from, *args, **kw)
    return FederatedTrainer(*args, **kw)


@pytest.mark.parametrize("dst", ["cuda", "cpu"])
def test_checkpoint_saved_on_card_restores_bitwise(cuda, dst, tmp_path):
    """FedVARP under Markov availability with a FedAdam server step,
    saved on the card: restored on the card and on the CPU, the params,
    the (8, N) table, Δ_prev, the moments and the chain are bit for bit
    the saved ones, and the resumed run goes on."""
    data = build_federated_image_data(num_classes=10, num_clients=8,
                                      alpha=0.5, samples_per_class=16,
                                      test_per_class=2, seed=0)
    params = init_vision(paper_lenet5.CONFIG, jax_prng.PRNGKey(0))
    tr = _fedvarp_adam_trainer(data, params, "cuda")
    for t in range(2):
        tr.run_round(t)
    tr.save(str(tmp_path))
    res = _fedvarp_adam_trainer(data, params, dst, str(tmp_path))
    assert res.start_round == 2 and res.flat.device.type == dst
    pairs = [(res.flat, tr.flat)]
    pairs += [(res.server_state[k], tr.server_state[k])
              for k in ("y", "delta_prev")]
    pairs += [(res._opt_state[k], tr._opt_state[k]) for k in ("m", "v")]
    for got, want in pairs:
        assert got.device.type == dst
        assert torch.equal(got.cpu(), want.cpu())
    assert bool((tr.server_state["y"] != 0).any())
    # the chain as of the saved frontier (the staging ring of ``tr`` has
    # sampled rounds past it)
    assert res.sampler.state_dict() == tr.state().sampler_state
    assert np.isfinite(res.run_round(2).train_loss)


def test_async_int8_trainer_on_card_matches_cpu(cuda):
    """Buffered-async FedDPC with an int8 uplink and error feedback:
    every fold goes through feddpc_dequant_buffer_fold on the card, and
    the run agrees with the same run on the CPU."""
    cfg = paper_lenet5.CONFIG
    data = build_federated_image_data(num_classes=10, num_clients=8,
                                      alpha=0.5, samples_per_class=16,
                                      test_per_class=2, seed=0)
    params = init_vision(cfg, jax_prng.PRNGKey(0))
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
    params = init_vision(cfg, jax_prng.PRNGKey(0))
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
# ring decode whose window leaves most splits dark, prefills at D 32,
# 64, 128 and 256 with Sq not a multiple of 16 (bf16: the tensor cores),
# and prefills and decodes at D 192 and 112
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
            (2, 77, 90, 8, 2, 256, 0, 0.0, 3),
            # MLA's head dim (192: tensor cores in bf16) and Kimi-K2's
            # (112: CUDA cores), prefill and decode
            (2, 77, 90, 8, 8, 192, 0, 0.0, 3),
            (4, 1, 300, 8, 8, 192, 0, 0.0, 5),
            (2, 77, 90, 8, 2, 112, 0, 0.0, 3),
            (4, 1, 300, 8, 2, 112, 0, 0.0, 5)]


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


# ---- the encoder-decoder, MoE, MLA and hybrid decoders ----

@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-1.5-large-398b",
                                  "kimi-k2-1t-a32b"])
def test_moe_decoders_on_card_match_cpu(cuda, arch):
    """The MoE SMOKE configs (MLA, hybrid Mamba + attention, GQA) from the
    same params and prompts on the card and on the CPU, f32: prefill and
    4 teacher-forced decode steps within 1e-4, and the card's launches:
    a flash call an attention layer a step (MLA's absorbed decode none),
    a scan an SSM layer a step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True)
    params = tf.init_lm(cfg, torch.Generator().manual_seed(0), torch.float32)
    prompts = torch.randint(0, cfg.vocab_size, (3, 20),
                            generator=torch.Generator().manual_seed(1))
    kinds = [kind for kind, _ in tf.layer_specs(cfg)]
    fa_ops.reset_launches()
    ss_ops.reset_launches()
    got = _teacher_forced(cfg, params, prompts, 4, cuda, torch.float32)
    decode_flash = 0 if cfg.attention == "mla" else kinds.count("attn")
    assert fa_ops.flash_attention.launches == \
        kinds.count("attn") + 4 * decode_flash
    assert ss_ops.ssm_scan.launches == 5 * kinds.count("ssm")
    want = _teacher_forced(cfg, params, prompts, 4, "cpu", torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_encdec_on_card_matches_cpu(cuda):
    """Whisper SMOKE from the same params and frames on the card and on
    the CPU, f32: serve_encdec's greedy tokens equal, and its launches —
    one flash call an encoder layer, then two a decoder layer a step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.models import encdec
    cfg = get_config("whisper-base", smoke=True)
    params = encdec.init_encdec(cfg, torch.Generator().manual_seed(0),
                                torch.float32)
    frames = torch.randn(2, cfg.encoder_seq_len, cfg.d_model,
                         generator=torch.Generator().manual_seed(1))
    fa_ops.reset_launches()
    got, _ = serve.serve_encdec(cfg, 2, 5, device="cuda",
                                params=tree_map(lambda t: t.to(cuda), params),
                                frames=frames.to(cuda))
    assert fa_ops.flash_attention.launches == \
        cfg.encoder_layers + 2 * cfg.num_layers * 5
    want, _ = serve.serve_encdec(cfg, 2, 5, device="cpu", params=params,
                                 frames=frames)
    assert torch.equal(got.cpu(), want)


# ---- the training route on the card ----

@pytest.mark.parametrize("arch", ["starcoder2-3b", "falcon-mamba-7b",
                                  "llava-next-mistral-7b"])
def test_training_route_launches_no_serving_kernel(cuda, arch):
    """loss_fn and a make_train_step step on the card take the plain
    attention and scan (neither kernel has a backward): no flash_attention
    or ssm_scan launch, and the step's loss and params match the CPU's."""
    from repro_torch.launch import steps
    cfg = get_config(arch, smoke=True)
    params = tf.init_lm(cfg, jax_prng.PRNGKey(0), torch.float32)
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.modality == "vision":
        batch["patch_embeds"] = 0.02 * torch.randn(
            2, cfg.num_patches, cfg.d_model, generator=g)
    step = steps.make_train_step(cfg, lr=0.01, remat="full")
    fa_ops.reset_launches()
    ss_ops.reset_launches()
    got, loss = step(tree_map(lambda t: t.to(cuda), params),
                     {k: v.to(cuda) for k, v in batch.items()})
    assert fa_ops.flash_attention.launches == 0
    assert ss_ops.ssm_scan.launches == 0
    want, want_loss = step(params, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_kernels_refuse_training_inputs_on_the_card(cuda):
    """On CUDA tensors the wrappers raise before launching: an input that
    requires grad, or one under torch.func, never reaches the kernel."""
    from torch.func import grad
    q = torch.randn(1, 8, 2, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 8, 1, 64, device=cuda)
    pos = torch.arange(8, device=cuda)[None]
    fa_ops.reset_launches()
    with pytest.raises(ValueError, match="no backward"):
        fa_ops.flash_attention(q, k, k, pos, pos)
    with pytest.raises(ValueError, match="no backward"):
        grad(lambda q: fa_ops.flash_attention(q, k, k, pos, pos).sum())(
            q.detach())
    assert fa_ops.flash_attention.launches == 0
    u = torch.randn(1, 4, 8, device=cuda, requires_grad=True)
    dt = torch.rand(1, 4, 8, device=cuda)
    b = torch.randn(1, 4, 4, device=cuda)
    a = -torch.rand(8, 4, device=cuda)
    ss_ops.reset_launches()
    with pytest.raises(ValueError, match="no backward"):
        ss_ops.ssm_scan(u, dt, b, b, a, torch.ones(8, device=cuda))
    assert ss_ops.ssm_scan.launches == 0
