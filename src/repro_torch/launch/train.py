"""End-to-end federated training driver (simulation mode — the paper's
experiment on synthetic heterogeneous data), on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --model resnet18-gn --num-classes 100 --algorithm feddpc \\
      --rounds 50 --alpha 0.2 --clients 100 --participation 0.1 \\
      --eta-l 0.01 --eta-g 0.01

Counterpart of repro/launch/train.py with its main-path, buffered-async,
codec and chaos flags; vision data streams from the synthetic Dirichlet-
partitioned image task, and the participation model is uniform.
``--device cpu`` runs on the CPU; without it the script raises when CUDA
is absent. Buffered-async rounds with an int8 uplink and error feedback:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model lenet5 --async-buffer --runtime exponential \\
      --buffer-size 2 --async-concurrency 3 --codec int8 --codec-ef

Guarded rounds under injected faults and a round deadline:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model lenet5 --guard --round-deadline 2.0 --runtime exponential \\
      --fault-plan '{"seed": 0, "injectors": [{"kind": "nan_delta",
      "rate": 0.2}]}'
"""
from __future__ import annotations

import argparse
import functools
import json

import torch

from repro_torch.core.api import (AlgoConfig, ExecConfig, FederatedTrainer,
                                  resolve_device)
from repro_torch.codec import codec_names
from repro_torch.core.baselines import default_hyper
from repro_torch.core.faults import FaultPlan
from repro_torch.core.runtime import make_runtime
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
    ap.add_argument("--async-buffer", action="store_true",
                    help="buffered-async rounds: waves train against "
                         "possibly-stale snapshots and the server steps "
                         "every --buffer-size arrivals with staleness-"
                         "discounted aggregation")
    ap.add_argument("--buffer-size", type=int, default=None,
                    help="arrivals per async server step (default: the "
                         "cohort size — the sync-equivalent anchor)")
    ap.add_argument("--staleness-alpha", type=float, default=0.5,
                    help="staleness discount exponent: w(s)=(1+s)^-alpha")
    ap.add_argument("--async-concurrency", type=int, default=1,
                    help="max waves in flight at once (>1 lets fresh "
                         "waves overlap stale stragglers)")
    ap.add_argument("--runtime", default="deterministic",
                    choices=["deterministic", "exponential", "heavytail",
                             "markov"],
                    help="client runtime model: arrival latencies + "
                         "dropout of the async waves (core/runtime.py)")
    ap.add_argument("--runtime-dropout", type=float, default=0.0,
                    help="per-wave client dropout probability of the "
                         "exponential/heavytail/markov runtime models")
    ap.add_argument("--codec", default=None, choices=codec_names(),
                    help="delta codec for the client->server uplink: "
                         "quantized wire payloads with per-leaf scales; "
                         "identity is bitwise equal to no codec")
    ap.add_argument("--codec-ef", action="store_true",
                    help="server-side error feedback for a lossy --codec: "
                         "clients ship delta + the running mean "
                         "quantization residual (needs a lossy codec)")
    ap.add_argument("--guard", action="store_true",
                    help="update guard: quarantine non-finite / exploded-"
                         "norm client deltas, clip outliers against the "
                         "rolling robust norm threshold")
    ap.add_argument("--round-deadline", type=float, default=None,
                    help="virtual-seconds round deadline: sync rounds "
                         "drop and mask clients whose runtime draw misses "
                         "it; async rounds fold the partial buffer (the "
                         "--runtime model draws the latencies)")
    ap.add_argument("--fault-plan", default=None,
                    help="chaos harness: a JSON FaultPlan config (inline, "
                         "or @/path/to/plan.json) — the seeded injector "
                         "schedule of core/faults.py")
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
                     vectorize=not args.serial,
                     async_buffer=args.async_buffer,
                     buffer_size=args.buffer_size,
                     staleness_alpha=args.staleness_alpha,
                     async_concurrency=args.async_concurrency,
                     codec=args.codec,
                     codec_ef=True if args.codec_ef else None,
                     guard=args.guard, round_deadline=args.round_deadline)
    runtime = None
    if args.async_buffer or args.round_deadline is not None:
        rt_kw = ({} if args.runtime == "deterministic"
                 else {"dropout": args.runtime_dropout})
        runtime = make_runtime(args.runtime, args.clients, **rt_kw)
    fault_plan = None
    if args.fault_plan:
        raw = args.fault_plan
        if raw.startswith("@"):
            with open(raw[1:]) as fh:
                raw = fh.read()
        fault_plan = FaultPlan.from_config(json.loads(raw))
    trainer = FederatedTrainer(loss_fn, params, args.clients, source, cfg,
                               eval_fn, algo=algo,
                               sampler=UniformSampler(args.clients, cohort),
                               runtime=runtime, fault_plan=fault_plan,
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
