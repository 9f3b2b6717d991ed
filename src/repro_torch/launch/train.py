"""End-to-end federated training driver (simulation mode — the paper's
experiment on synthetic heterogeneous data), on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --model resnet18-gn --num-classes 100 --algorithm feddpc \\
      --rounds 50 --alpha 0.2 --clients 100 --participation 0.1 \\
      --eta-l 0.01 --eta-g 0.01

Counterpart of repro/launch/train.py with its main-path flags; vision
data streams from the synthetic Dirichlet-partitioned image task, and
the participation model is uniform. ``--device cpu`` runs on the CPU;
without it the driver raises when CUDA is absent.
"""
from __future__ import annotations

import argparse
import functools
import json

import torch

from repro_torch.core.api import (AlgoConfig, ExecConfig, FederatedTrainer,
                                  resolve_device)
from repro_torch.core.baselines import default_hyper
from repro_torch.core.samplers import UniformSampler
from repro_torch.ingest.images import (StreamingImageSource,
                                       build_federated_image_data)
from repro_torch.models.vision import (VisionConfig, init_vision,
                                       vision_forward, vision_loss_fn)

EVAL_CHUNK = 1000      # test images per forward pass


def build_vision_task(args, device: torch.device):
    family = "lenet5" if args.model == "lenet5" else "resnet18"
    nclass = 10 if args.model == "lenet5" else args.num_classes
    data = build_federated_image_data(
        num_classes=nclass, num_clients=args.clients, alpha=args.alpha,
        samples_per_class=args.samples_per_class, seed=args.seed)
    source = StreamingImageSource(data, args.batch_size, args.local_epochs)
    vc = VisionConfig(name=args.model, family=family, num_classes=nclass,
                      image_size=32)
    params = init_vision(vc, torch.Generator().manual_seed(args.seed))
    loss_fn = functools.partial(vision_loss_fn, vc)
    te_x = torch.from_numpy(data.test_images).to(device)
    te_y = torch.from_numpy(data.test_labels).to(device)

    def eval_fn(p):
        # in chunks: one forward over the whole test set would hold every
        # activation of ResNet18 at once
        correct = sum(
            (torch.argmax(vision_forward(vc, p, te_x[i:i + EVAL_CHUNK]), -1)
             == te_y[i:i + EVAL_CHUNK]).sum()
            for i in range(0, len(te_y), EVAL_CHUNK))
        return correct / len(te_y)

    return params, loss_fn, source, eval_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="lenet5",
                    choices=["lenet5", "resnet18-gn"])
    ap.add_argument("--algorithm", default="feddpc",
                    choices=["feddpc", "fedavg"])
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--participation", type=float, default=0.1)
    ap.add_argument("--alpha", type=float, default=0.2)
    ap.add_argument("--eta-l", type=float, default=0.01)
    ap.add_argument("--eta-g", type=float, default=0.01)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--samples-per-class", type=int, default=100)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--serial", action="store_true",
                    help="one client at a time instead of the "
                         "cohort-vectorized round (reference path)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a card")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    params, loss_fn, source, eval_fn = build_vision_task(args, device)
    cohort = max(1, int(round(args.clients * args.participation)))
    algo = AlgoConfig(name=args.algorithm, eta_l=args.eta_l,
                      eta_g=args.eta_g,
                      hyper=default_hyper(args.algorithm, lam=args.lam))
    cfg = ExecConfig(rounds=args.rounds, clients_per_round=cohort,
                     seed=args.seed, eval_every=args.eval_every,
                     vectorize=not args.serial)
    trainer = FederatedTrainer(loss_fn, params, args.clients, source, cfg,
                               eval_fn, algo=algo,
                               sampler=UniformSampler(args.clients, cohort),
                               device=device)
    hist = trainer.run(verbose=True)
    best, at = trainer.best_accuracy
    print(f"best eval {best} @ round {at}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump([r.__dict__ for r in hist], f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
