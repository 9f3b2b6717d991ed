"""Quickstart: FedDPC vs FedAvg on a heterogeneous federated image task
(counterpart of the reference's examples/quickstart.py).

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Trains LeNet5 over 15 federated rounds with Dirichlet(0.2)-partitioned
synthetic images, 10 of 30 clients participating per round — the paper's
setting at laptop scale — and shows FedDPC's faster loss reduction. The
initial params are the reference's draws from PRNGKey(0)
(core/jax_prng.py), so the printed losses are the reference example's.

The pieces compose explicitly:
  * ``StreamingImageSource`` streams per-client batches into the staging
    ring (no pre-materialized lists);
  * ``UniformSampler`` is the paper's participation model — swap in
    ``WeightedSampler(source.client_weights(), 10)`` or
    ``MarkovSampler(30, 10)`` to study other participation regimes;
  * ``AlgoConfig(name=..., hyper=...)`` resolves the server rule through
    the algorithm registry (``FedDPCHyper(lam=...)`` etc.);
  * ``ExecConfig`` carries the execution levers (the cohort-vectorized
    round is the default; ``vectorize=False`` runs one client at a time).

Each round trains the 10-client cohort at once: its parameters a (10, N)
stack, local training ``torch.func.vmap``-ed over it, and FedDPC's server
step two hand-written kernels on the card (kernels/feddpc_project).
"""
from __future__ import annotations

import argparse
import functools

import torch

from repro_torch.core import jax_prng
from repro_torch.core.api import (AlgoConfig, ExecConfig, FederatedTrainer,
                                  resolve_device)
from repro_torch.core.baselines import FedDPCHyper
from repro_torch.core.samplers import UniformSampler
from repro_torch.ingest.images import (StreamingImageSource,
                                       build_federated_image_data)
from repro_torch.models.vision import (VisionConfig, init_vision,
                                       vision_accuracy, vision_loss_fn)

ALGORITHMS = ("fedavg", "feddpc")


def main(rounds: int = 15, num_clients: int = 30, cohort: int = 10,
         device="cuda"):
    """Runs FedAvg, then FedDPC; returns {name: history}."""
    device = resolve_device(device)
    vc = VisionConfig(name="quickstart", family="lenet5", num_classes=10)
    data = build_federated_image_data(
        num_classes=10, num_clients=num_clients, alpha=0.2,  # heterogeneous!
        samples_per_class=100, test_per_class=20, seed=0)
    params = init_vision(vc, jax_prng.PRNGKey(0))
    loss_fn = functools.partial(vision_loss_fn, vc)
    source = StreamingImageSource(data, batch_size=64)

    te_x = torch.from_numpy(data.test_images).to(device)
    te_y = torch.from_numpy(data.test_labels).to(device)

    def eval_fn(p):
        return vision_accuracy(vc, p, te_x, te_y)

    histories = {}
    for name in ALGORITHMS:
        algo = AlgoConfig(name=name, eta_l=0.02, eta_g=0.02,
                          hyper=FedDPCHyper(lam=1.0) if name == "feddpc"
                          else None)
        cfg = ExecConfig(rounds=rounds, clients_per_round=cohort,
                         eval_every=5)
        with FederatedTrainer(loss_fn, params, data.num_clients, source,
                              cfg, eval_fn, algo=algo,
                              sampler=UniformSampler(data.num_clients,
                                                     cohort),
                              device=device) as trainer:
            hist = trainer.run(verbose=True)
            best, at = trainer.best_accuracy
        # median over the rounds after round 0 (round 0 alone when
        # --rounds 1): round 0 carries the first launches' set-up
        timed = hist[1:] or hist
        sec = sorted(r.seconds for r in timed)[(len(timed) - 1) // 2]
        print(f"--> {name}: best test acc {best:.4f} @ round {at}, "
              f"final loss {hist[-1].train_loss:.4f}, "
              f"{sec * 1e3:.1f} ms/round (median)\n")
        histories[name] = hist
    return histories


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--clients", type=int, default=30)
    ap.add_argument("--cohort", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a card")
    a = ap.parse_args()
    main(a.rounds, a.clients, a.cohort, a.device)
