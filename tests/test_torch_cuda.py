"""The port on the card: the CUDA kernels against their plain versions,
and the server step and a trainer round on CUDA against the same on the
CPU. Marked ``cuda``; each test skips without a card. This file imports
no JAX, so it also runs where only the port is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import paper_lenet5
from repro_torch.core import feddpc
from repro_torch.core.api import AlgoConfig, ExecConfig, FederatedTrainer
from repro_torch.ingest.images import (StreamingImageSource,
                                       build_federated_image_data)
from repro_torch.kernels.feddpc_project import ops, ref
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
    assert [fn.launches - b for fn, b in zip(ops.KERNELS, before)] == [1, 1]


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
        assert added == ([2, 2] if dev == "cuda" else [0, 0])
    # TF32 off: card and CPU differ by conv algorithms and sum orders
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-3)
