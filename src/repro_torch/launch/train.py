"""End-to-end federated training driver (simulation mode — the paper's
experiment on synthetic heterogeneous data), on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --model resnet18-gn --num-classes 100 --algorithm feddpc \\
      --rounds 50 --alpha 0.2 --clients 100 --participation 0.1 \\
      --eta-l 0.01 --eta-g 0.01

Counterpart of repro/launch/train.py with its main-path, buffered-async,
codec, chaos, checkpoint, health and ingest flags, every registered
server rule (``--algorithm``), the four participation samplers
(``--sampler``) and the server optimizer (``--server-opt``). The initial
params are the reference's draws from ``PRNGKey(--seed)``
(core/jax_prng.py), so a run repeats the reference CLI's at the same
arguments. Vision data streams through the staged ingest pipeline
(prefetched, copied to the card on the producer thread;
``--prefetch-depth``, ``--host-staged``): synthetic by default, or the
paper's real datasets from their standard download layout with
``--dataset cifar10|cifar100|tiny-imagenet --data-root DIR`` (and
``--augment``, ``--decode-workers``). ``--device cpu`` runs on the CPU;
without it the script raises when CUDA is absent. FedVARP under Markov
availability with a FedAdam server step:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model lenet5 --algorithm fedvarp --sampler markov \\
      --markov-p-on 0.5 --markov-p-off 0.5 --server-opt fedadam

CIFAR-100 from disk with crop-and-flip augmentation and a stochastic-
rounding int8 uplink (its noise is the reference's):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model resnet18-gn --dataset cifar100 \\
      --data-root tests/fixtures/data --augment --clients 4 \\
      --participation 0.5 --codec int8_sr

Buffered-async rounds with an int8 uplink and error feedback:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model lenet5 --async-buffer --runtime exponential \\
      --buffer-size 2 --async-concurrency 3 --codec int8 --codec-ef

Guarded rounds under injected faults and a round deadline:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model lenet5 --guard --round-deadline 2.0 --runtime exponential \\
      --fault-plan '{"seed": 0, "injectors": [{"kind": "nan_delta",
      "rate": 0.2}]}'

Federated LM training (the beyond-paper scenario: cross-silo pretraining
on topic-skewed Zipf streams) with any arch's SMOKE config — a dense
decoder, DeepSeek-V2 (MLA + MoE), Kimi-K2 (MoE), Falcon-Mamba, the
hybrid Jamba, LLaVA-NeXT's VLM trunk (on text alone) or whisper-base's
decoder-only stack, each as the reference's CLI trains it — and the
reference's init, data and holdout eval (``-loss``):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model starcoder2-3b --seq-len 33 --rounds 2 --clients 4 \\
      --participation 0.5 --batch-size 4 --eval-every 1

The cohort over two processes on the CPU (gloo), each rank training its
slice of the cohort, with two edge aggregators (the script joins the job
that ``launch/distributed.spawn_local`` sets up; ``--shard-clients``
without a job is a single-process run):

  PYTHONPATH=src python -c "import sys; from repro_torch.launch import \
      distributed as d; d.spawn_local([sys.executable, '-m', \
      'repro_torch.launch.train', '--device', 'cpu', '--model', 'lenet5', \
      '--rounds', '2', '--clients', '6', '--participation', '0.5', \
      '--shard-clients', '--edges', '2'], 2, capture=False)"

The model axis on four processes: a (2 clients x 2 model) mesh, each
rank holding a shard of the params and server state (add
``'--model-shards', '2'`` to the list above and spawn 4).

Checkpoint every round with the run-health monitor on, then pick the run
up where it stopped (the checkpoints are the reference's format: either
package's driver resumes the other's):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model lenet5 --rounds 4 --ckpt-dir ckpt --ckpt-every 1 --health \\
      --health-log health.jsonl
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model lenet5 --rounds 8 --ckpt-dir ckpt --resume --health
"""
from __future__ import annotations

import argparse
import functools
import json

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.api import (AlgoConfig, ExecConfig, FederatedTrainer,
                                  resolve_device)
from repro_torch.launch.distributed import is_coordinator, maybe_initialize
from repro_torch.codec import codec_names
from repro_torch.core.baselines import ALGORITHM_NAMES, default_hyper
from repro_torch.core import jax_prng
from repro_torch.core.faults import FaultPlan
from repro_torch.core.runtime import make_runtime
from repro_torch.core.samplers import (CyclicSampler, MarkovSampler,
                                       UniformSampler, WeightedSampler)
from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.optim.server import SERVER_OPTIMIZER_NAMES
from repro_torch.ingest.datasets import (CIFAR10Source, CIFAR100Source,
                                         TinyImageNetSource)
from repro_torch.ingest.images import (StreamingImageSource,
                                       build_federated_image_data)
from repro_torch.ingest.sources import ListDataSource
from repro_torch.models import transformer as tf
from repro_torch.models.vision import (VisionConfig, init_vision,
                                       vision_forward, vision_loss_fn)

EVAL_CHUNK = 1000      # test images per forward pass
VISION_MODELS = ("lenet5", "resnet18-gn")
# the ARCH ids whose decoders the port trains: every one (a VLM's trunk
# on text alone; whisper-base as a decoder-only stack of its widths, as
# the reference's CLI builds it)
LM_MODELS = ("starcoder2-3b", "minitron-8b", "llava-next-mistral-7b",
             "falcon-mamba-7b", "phi4-mini-3.8b", "deepseek-v2-236b",
             "command-r-35b", "whisper-base", "jamba-1.5-large-398b",
             "kimi-k2-1t-a32b")
LM_DOCS_PER_CLIENT = 16
LM_HOLDOUT = 64        # holdout sequences of the eval


def build_vision_task(args, cfg: ExecConfig, device: torch.device):
    """(params, loss_fn, source, eval_fn) of a CLI run. The source's batch
    size, local epochs and decode pool are ``cfg``'s."""
    family = "lenet5" if args.model == "lenet5" else "resnet18"
    if args.dataset == "synthetic":
        nclass = 10 if args.model == "lenet5" else args.num_classes
        data = build_federated_image_data(
            num_classes=nclass, num_clients=args.clients, alpha=args.alpha,
            samples_per_class=args.samples_per_class, seed=args.seed)
        source = StreamingImageSource(data, cfg.batch_size,
                                      cfg.local_epochs)
        test_x, test_y = data.test_images, data.test_labels
        image_size = 32
    else:
        # disk-backed reader: Dirichlet-partitioned on load, records
        # decoded (and augmented) lazily on the staging thread
        if not args.data_root:
            raise SystemExit(f"--dataset {args.dataset} needs --data-root "
                             "(the standard download directory)")
        src_cls = {"cifar10": CIFAR10Source, "cifar100": CIFAR100Source,
                   "tiny-imagenet": TinyImageNetSource}[args.dataset]
        src_kw = {}
        if args.dataset == "tiny-imagenet":
            src_kw["decode_workers"] = cfg.decode_workers
        source = src_cls(args.data_root, num_clients=args.clients,
                         alpha=args.alpha, batch_size=cfg.batch_size,
                         local_epochs=cfg.local_epochs,
                         augment=args.augment, seed=args.seed, **src_kw)
        nclass = source.num_classes
        test_x, test_y = source.test_arrays()
        image_size = 64 if args.dataset == "tiny-imagenet" else 32
    vc = VisionConfig(name=args.model, family=family, num_classes=nclass,
                      image_size=image_size)
    params = init_vision(vc, jax_prng.PRNGKey(args.seed))
    loss_fn = functools.partial(vision_loss_fn, vc)
    te_x = torch.from_numpy(test_x).to(device)
    te_y = torch.from_numpy(test_y).to(device)

    def eval_fn(p):
        # in chunks: one forward over the whole test set would hold every
        # activation of ResNet18 at once
        correct = sum(
            (torch.argmax(vision_forward(vc, p, te_x[i:i + EVAL_CHUNK]), -1)
             == te_y[i:i + EVAL_CHUNK]).sum()
            for i in range(0, len(te_y), EVAL_CHUNK))
        return correct / len(te_y)

    return params, loss_fn, source, eval_fn


def build_lm_task(args, cfg: ExecConfig, device: torch.device):
    """(params, loss_fn, source, eval_fn) of federated LM training, as the
    reference CLI builds it: ``args.model``'s SMOKE config in f32 from
    ``PRNGKey(seed)``; clients x 16 Zipf documents of ``--seq-len``
    tokens, Dirichlet-partitioned over their topics; client c's round-t
    batch is ``--batch-size`` of its documents, shuffled by
    ``RandomState(hash((c, t)))`` (repeated when it has fewer); the eval
    is minus the loss on the first 64 documents. The batches are text
    alone for every arch, as in the reference's CLI: a VLM's trunk trains
    without patch embeddings, and whisper-base is ``init_lm``'s
    decoder-only stack of its widths (no encoder, no positions)."""
    arch = get_config(args.model, smoke=True)
    tokens, topics = make_lm_dataset(args.clients * LM_DOCS_PER_CLIENT,
                                     args.seq_len, arch.vocab_size,
                                     seed=args.seed)
    parts = dirichlet_partition(topics, args.clients, args.alpha,
                                seed=args.seed, min_size=1)
    params = tf.init_lm(arch, jax_prng.PRNGKey(args.seed), torch.float32)
    bsz = cfg.batch_size

    def lm_batch(tk):
        return {"tokens": tk[:, :-1], "labels": tk[:, 1:]}

    def batch_fn(c, t):
        idx = parts[c]
        rng = np.random.RandomState(hash((c, t)) % (2 ** 31))
        sel = idx[rng.permutation(len(idx))][:bsz]
        if len(sel) < bsz:
            sel = np.concatenate([sel] * ((bsz // max(len(sel), 1))
                                          + 1))[:bsz]
        return [lm_batch(tokens[sel])]

    holdout = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in lm_batch(tokens[:LM_HOLDOUT]).items()}

    # with --model-shards M every LM family (MLA, Mamba, hybrid, MoE)
    # trains tensor-parallel over the model group (transformer.LMLoss;
    # core/round.cohort_local_update)
    loss_fn = tf.LMLoss(arch)

    def eval_fn(p):    # negative perplexity proxy -> the "accuracy" slot
        with torch.no_grad():
            return -loss_fn(p, holdout)

    return params, loss_fn, ListDataSource(batch_fn), eval_fn


def build_sampler(args, source, num_clients: int, cohort: int):
    if args.sampler == "uniform":
        return UniformSampler(num_clients, cohort)
    if args.sampler == "weighted":
        # weighted by each client's data size where the source knows it
        weights = (source.client_weights()
                   if hasattr(source, "client_weights")
                   else np.ones(num_clients))
        return WeightedSampler(weights, cohort)
    if args.sampler == "cyclic":
        return CyclicSampler(num_clients, cohort)
    if args.sampler == "markov":
        return MarkovSampler(num_clients, cohort, p_on=args.markov_p_on,
                             p_off=args.markov_p_off)
    raise ValueError(args.sampler)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="lenet5",
                    choices=[*VISION_MODELS, *LM_MODELS],
                    help="a vision model of the paper, or an ARCH id the "
                         "port trains federated (its SMOKE config)")
    ap.add_argument("--algorithm", default="feddpc",
                    choices=ALGORITHM_NAMES)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--participation", type=float, default=0.1)
    ap.add_argument("--sampler", default="uniform",
                    choices=["uniform", "weighted", "cyclic", "markov"])
    ap.add_argument("--markov-p-on", type=float, default=0.5)
    ap.add_argument("--markov-p-off", type=float, default=0.5)
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "cifar10", "cifar100",
                             "tiny-imagenet"],
                    help="vision data: offline synthetic (default) or a "
                         "disk-backed reader over the standard download "
                         "layout under --data-root")
    ap.add_argument("--data-root", default=None,
                    help="directory holding cifar-10-batches-py / "
                         "cifar-100-python / tiny-imagenet-200")
    ap.add_argument("--augment", action="store_true",
                    help="random crop + flip on the ingest path "
                         "(disk-backed datasets)")
    ap.add_argument("--decode-workers", type=int, default=0,
                    help="thread pool for the per-image file decode of "
                         "tiny-imagenet; 0 = serial, same output order")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="staging-ring depth: cohort buffers the ingest "
                         "pipeline cycles through")
    ap.add_argument("--host-staged", action="store_true",
                    help="copy the staged cohort to the card on the "
                         "consumer thread (timed as ingest_device_seconds) "
                         "instead of the staging thread")
    ap.add_argument("--ingest-stall-s", type=float, default=None,
                    help="staging-ring stall deadline in seconds (a hung "
                         "producer raises instead of waiting forever)")
    ap.add_argument("--ingest-max-restarts", type=int, default=0,
                    help="supervised staging-producer restarts: retry a "
                         "failed staging up to N times over the run "
                         "(bounded exponential backoff), then fail")
    ap.add_argument("--alpha", type=float, default=0.2)
    ap.add_argument("--eta-l", type=float, default=0.01)
    ap.add_argument("--eta-g", type=float, default=0.01)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--seq-len", type=int, default=128,
                    help="LM task: tokens a document (the batches hold "
                         "seq_len - 1 input tokens)")
    ap.add_argument("--samples-per-class", type=int, default=100)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--shard-clients", action="store_true",
                    help="in a multi-process job, spread the cohort over "
                         "the ranks (each trains its slice); without a "
                         "job a no-op")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="model-axis shards per client slice: with "
                         "--shard-clients in a job whose ranks it divides, "
                         "each rank holds a shard of the params and server "
                         "state (a (ranks // M, M) clients x model mesh)")
    ap.add_argument("--edges", type=int, default=None,
                    help="hierarchical aggregation: E edge aggregators, "
                         "each folding an equal contiguous slice of the "
                         "padded cohort; must divide it")
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
    ap.add_argument("--server-opt", default="sgd",
                    choices=SERVER_OPTIMIZER_NAMES,
                    help="server-side optimizer: precondition every "
                         "rule's proposed step with fedadam/fedyogi "
                         "moments; sgd (default) applies it verbatim")
    ap.add_argument("--health", action="store_true",
                    help="run-health monitor: rolling-median loss spike / "
                         "NaN detection, staleness and quarantine-rate "
                         "trend alarms over the RoundRecord stream")
    ap.add_argument("--health-patience", type=int, default=None,
                    help="early-stop after N consecutive alarmed rounds "
                         "(needs --health; default: alarms only)")
    ap.add_argument("--health-log", default=None,
                    help="stream every health verdict to this JSONL file "
                         "as the run goes (needs --health; one JSON object "
                         "per round, flushed per verdict)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a card")
    ap.add_argument("--out", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save the TrainerState every N rounds (0 = only "
                         "at the end, and only when --ckpt-dir is set)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest intact TrainerState from "
                         "--ckpt-dir and continue the run exactly where it "
                         "stopped")
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume needs --ckpt-dir")

    # join the job (if spawned into one) before the first device query:
    # a rank's card becomes the current device
    maybe_initialize()
    device = resolve_device(args.device)
    cohort = max(1, int(round(args.clients * args.participation)))
    algo = AlgoConfig(name=args.algorithm, eta_l=args.eta_l,
                      eta_g=args.eta_g,
                      hyper=default_hyper(args.algorithm, lam=args.lam),
                      server_opt=args.server_opt)
    cfg = ExecConfig(rounds=args.rounds, clients_per_round=cohort,
                     seed=args.seed, eval_every=args.eval_every,
                     vectorize=not args.serial,
                     shard_clients=args.shard_clients,
                     shard_model=args.model_shards, edges=args.edges,
                     prefetch_depth=args.prefetch_depth,
                     device_stage=not args.host_staged,
                     ingest_stall_s=args.ingest_stall_s,
                     ingest_max_restarts=args.ingest_max_restarts,
                     decode_workers=args.decode_workers,
                     batch_size=args.batch_size,
                     local_epochs=args.local_epochs,
                     async_buffer=args.async_buffer,
                     buffer_size=args.buffer_size,
                     staleness_alpha=args.staleness_alpha,
                     async_concurrency=args.async_concurrency,
                     codec=args.codec,
                     codec_ef=True if args.codec_ef else None,
                     guard=args.guard, round_deadline=args.round_deadline,
                     health=args.health,
                     health_patience=args.health_patience,
                     health_log=args.health_log)
    build = (build_vision_task if args.model in VISION_MODELS
             else build_lm_task)
    params, loss_fn, source, eval_fn = build(args, cfg, device)
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
    kw = dict(algo=algo, sampler=build_sampler(args, source, args.clients,
                                               cohort),
              runtime=runtime, fault_plan=fault_plan, device=device)
    if args.resume:
        trainer = FederatedTrainer.resume(args.ckpt_dir, loss_fn, params,
                                          args.clients, source, cfg,
                                          eval_fn, **kw)
        print(f"resumed from {args.ckpt_dir} at round "
              f"{trainer.start_round}")
    else:
        trainer = FederatedTrainer(loss_fn, params, args.clients, source,
                                   cfg, eval_fn, **kw)
    with trainer:
        if args.ckpt_dir and args.ckpt_every > 0:
            for t in range(trainer.start_round, args.rounds):
                rec = trainer.run_round(t)
                print(f"[{args.algorithm}] round {t:4d} "
                      f"loss={rec.train_loss:.4f}")
                if (t + 1) % args.ckpt_every == 0:
                    trainer.save(args.ckpt_dir)
            trainer.finalize()
            hist = trainer.history
        else:
            hist = trainer.run(verbose=True)
        if args.ckpt_dir:
            path = trainer.save(args.ckpt_dir)
            print("checkpoint written to", path)
        best, at = trainer.best_accuracy
        if args.health and trainer.health_report is not None:
            hr = trainer.health_report
            print(f"health: {hr.alarmed_rounds} alarmed rounds "
                  f"(spikes {hr.spike_rounds}, "
                  f"nonfinite {hr.nonfinite_rounds})"
                  + (" — EARLY STOP" if hr.should_stop else ""))
    print(f"best eval {best} @ round {at}")
    if args.out and is_coordinator():
        with open(args.out, "w") as f:
            json.dump([r.__dict__ for r in hist], f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
