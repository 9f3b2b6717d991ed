#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing JSON lines; any failure raises and exits non-zero:

  1. build    nvcc-builds the FedDPC, flash-attention, ssm_scan and
              int8_sr libraries from the checkout's sources, all four at
              once (and ptxas's registers and spills of the int8_sr
              kernel);
              prints the card's name, power limit and top SM clock
              (nvidia-smi), ptxas's registers and spills of each FedDPC
              kernel instance and of each flash-attention kernel and the
              count of tensor-core (HMMA)
              instructions in the flash library's SASS (cuobjdump), which
              must not be 0; ptxas's registers and spills of each ssm_scan
              kernel and the SASS instruction mix of its hot loop, with
              the FP32-issue time it implies at the prefill shape.
  2. kernels  holds every kernel against its plain PyTorch version on the
              card: the reduction pass and the batched epilogue at the
              main path's shape (K=10 clients x N=11,220,132 ResNet18-GN
              parameters) and at ragged shapes, with and without a zero
              Delta_prev; the buffered fold and the two dequant folds at
              K = B in {1, 10, 33} (33 is past one shared-memory chunk of
              rows), int8 and bf16 payloads, on ResNet18-GN's 62 leaves
              and on a ragged synthetic layout with leaves shorter than a
              warp; the guard's reduction pass (with and without
              Delta_prev) at K in {1, 10, 33}, N = 11,220,132 and ragged
              1,000,003, on rows that are clean, hold scattered NaN/Inf,
              are all NaN or scaled by 1e12 (the non-finite count must
              match exactly); the one-client epilogue on f32 and bf16
              deltas. Times each kernel and its plain version with CUDA
              events at K = B = 10, N = 11,220,132, beside its bound:
              per call, over windows of 10 back-to-back calls (``ms``)
              and of one call (``ms_one_call``, with the host's launch
              path), median of 20 windows; the folds also cold (one call
              after an L2 flush and a spin, ``ms_cold_spin``) and as a
              share of their bound (``pct_of_bound``).
  2b. int8_sr the int8_sr codec's encode kernel (not a TPU kernel: the
              reference leaves the draw to XLA) against its plain int64
              version, bit for bit, at ResNet18-GN's 62-leaf layout (K = 1
              and K = 10) and on a ragged synthetic layout, both counter
              layouts of the PRNG, on the codec's own scales; the plain
              version's uniforms against core/jax_prng's numpy draw on one
              full leaf (the largest, two rows); timed at K = 10 beside its
              bound (bytes, and ~85 int32 operations an element at 64 an SM
              a clock) and its share of it.
  3. project  projection.project_and_scale(use_kernel=True) on one
              ResNet18-GN-sized flat delta: one feddpc_fused_epilogue
              launch, held against the same call on the CPU.
  4. trainer  the main paths: FederatedTrainer runs ResNet18-GN at full
              width (CIFAR-100 shape, synthetic Dirichlet(0.2) data, 10 of
              30 clients per round) in seven regimes — synchronous FedDPC
              and FedAvg (3 rounds each), synchronous FedDPC with an int8
              uplink, buffered-async FedDPC (B = 10, 2 waves in flight,
              exponential latencies) and the same with an int8 uplink and
              error feedback (4 rounds each); and the chaos layer: sync
              FedDPC with the update guard, a seeded fault plan (NaN and
              exploded deltas) and a round deadline of 2.0 under
              exponential latencies (4 rounds), and the async int8+EF
              regime with guard, faults and deadline (6 rounds); then the
              paper's baselines and ablations, 3 rounds each: FedProx,
              FedExP, FedGA, FedCM, FedVARP (uniform, and Markov
              availability with p_on = p_off = 0.5), FedYogi — no FedDPC
              kernel —, the projection-only ablation (one feddpc_dots and
              one feddpc_batched_epilogue a round), async FedDPC-M (one
              feddpc_dots and one feddpc_buffer_fold a fold) and FedDPC
              under a FedAdam server optimizer (dots and epilogue); int8_sr
              sync (one int8_sr_quantize and one dequant fold a round) and
              async int8_sr + EF (one int8_sr_quantize a wave, one dequant
              buffer fold a round); sync FedDPC host-staged and with
              prefetch off (4 rounds each, as the prefetched, device-staged
              run of the defaults), each profiled in its last round, then
              one staging line of the three (median round seconds after
              round 0, ingest_host_seconds and ingest_device_seconds
              medians, the profiled round's idle share). Every run uses
              the trainer's defaults: the staging ring with device
              staging and async eval. The
              launch counts are set to 0 just before each run and read
              just after; each round must launch the kernels of its
              regime. The chaos runs must quarantine exactly the plan's
              targets among the rows that arrive. Each run's summary line
              has its median round seconds after round 0, uplink bytes,
              diagnostics keys, launches and FedVARP's (30, N) f32 table
              bytes (on the card). The last round of sync FedDPC, FedAvg,
              sync chaos, async-int8 and FedVARP runs under
              torch.profiler: device time by kernel and by category (the
              codec's encode and decode as their own) and the card's idle
              share.
 4a. ingest   the staged ingest path at full width: ResNet18-GN on
              CIFAR100Source over the committed CIFAR-100 fixture
              (tests/fixtures/data, read-only) with crop-and-flip
              augmentation; sync FedDPC with an ingest_crash in round 1 and
              a restart budget of 1 (the restart charged to round 1, losses
              and params bit for bit the uninterrupted prefetched run's,
              both on cuDNN's deterministic algorithms);
              the same with no budget, which must raise, naming the crash.
 4b. checkpoint  save and resume at full width, in a temporary directory
              (launch counts set to 0 before it; cuDNN's deterministic
              algorithms, so that runs repeat bit for bit): sync FedDPC 4
              rounds uninterrupted twice, and 2 rounds, save, a fresh
              trainer's restore, rounds 2-3 (state bit for bit, one
              feddpc_dots and one feddpc_batched_epilogue a resumed round,
              losses within CKPT_LOSS_RTOL, params bitwise if the two
              uninterrupted runs are); FedVARP under Markov availability and
              FedAdam saved after round 2 (table, moments and chain bit for
              bit; save and restore seconds, bytes on disk, the host's RSS);
              async int8+EF and the async int8 chaos run saved mid-buffer
              (entries in flight, EF and the guard window back bit for bit,
              the regime's kernels each resumed round — the dequant fold
              without the guard —, the plan's targets quarantined); the newest
              step truncated, bit-flipped or stripped of its manifest (resume
              falls back to the step before with a RuntimeWarning and goes
              on); the health monitor stopping a NaN run with the reference's
              alarm, one log row a round.
 4c. multirank  the client axis across processes at full width:
              ResNet18-GN FedDPC (lam 1), 10 of 100 clients a round (12
              on 4 ranks, mr_cohort), 4 rounds, on cuDNN's deterministic
              algorithms, split over R
              ranks (launch/distributed.spawn_local re-running this script
              with --multirank-worker): R = min(4, cards) on NCCL with two
              cards or more, else R = 2 on the one card through gloo. Runs
              (a) shard_clients, (b) shard_clients with edges=2, (c) (b)
              with edge 1 dropped in round 2, (d) (b) cut at round 2 and
              rank 0's checkpoint resumed in this process to round 4; each
              held against this process's single-process run of the same
              ExecConfig: every round's loss and the final params within
              MR_RTOL relative, edge_dropped = 1 and one edge summary on
              the server uplink in (c)'s round 2, (d) against (b)'s end.
              Each rank prints its rows, its feddpc_dots and
              feddpc_batched_epilogue launches against what its rows and
              edges imply (one dots a round, one epilogue per edge piece a
              round), the ms of its collectives a round, its seconds a
              round and its peak memory.
 4d. model_axis  the model axis at full width (--model-axis-worker):
              4 NCCL ranks as (2 clients x 2 model) on four cards or
              more, (1 x 2) on two or three, 2 gloo ranks on one card.
              First each rank's int8 and int8_sr encode of its block of a
              (K, N) stack, bitwise the one-process encode (and a control
              that must differ); then multirank's task as (a) sharded2d,
              (b) codec_int8_2d, (c) server_fedadam_2d, (d) int8_sr, (e)
              (a) cut at round 2 and resumed here, (f) the ~101M LM on
              (1 x ranks), trained tensor-parallel (every model rank
              every row, on its shard; no param_all_gather or
              all_to_all on any rank); each against this process's
              one-process run.
              Each rank prints N_m against N/M, its bytes at rest, its
              peak memory (one process's beside it), its launches against
              its rows, the ms of the five collectives and its round s.
 4e. async_ranks  buffered-async rounds across ranks at full width
              (--async-ranks-worker, on model_axis's ranks): multirank's
              task with K a multiple of the ranks, B = K / 2, 2 waves in
              flight, ExponentialRuntime, 4 rounds: (a) int8 + EF and (b)
              int8_sr + EF on the client axis, (c), (d) the same on the
              (ranks / 2 x 2) mesh, (e) guarded f32 arrivals on the mesh
              cut at round 2 and resumed here; each against this
              process's one-process run, every fold's arrivals equal to
              its. Each rank prints its round s, the ms of its
              collectives a round, its peak memory, its in-flight bytes
              after each round and its launches against the folds it held
              arrivals in; the kernels line gets the ranks' launches
              (rank_launches).
  5. parity   LeNet5 at quickstart size on the card and on the CPU from
              the same initial params (the reference's draws,
              core/jax_prng.py) — 2 sync FedDPC rounds (prefetched, the
              default), 3 sync int8_sr rounds, 3
              buffered-async int8 rounds with error feedback, 3 sync
              rounds with guard, faults and deadline, and 3 rounds each of
              the projection-only ablation (the kernels against the plain
              route), FedVARP under a 2.0 round deadline (ID_SENTINEL rows
              on the card; the tables within TABLE_ATOL) and FedCM; the
              per-round losses (and the chaos counters) must agree. A
              checkpoint of 2 sync FedDPC rounds written on the card
              resumes on the CPU, and one written on the CPU on the card:
              both go on within PARITY_ATOL of the CPU's 4-round run. The
              training CLI at the README's LeNet5 arguments on the card and
              on the CPU: the CPU prints the reference CLI's losses and
              accuracies, the card's losses are within PARITY_ATOL.

  6. attention  flash_attention against its plain version on the card,
              f32 and bf16: StarCoder2-3B's prefill (B = 8, Sq = 1024,
              Sk = 1056 with the last 32 slots empty, H = 24, KV = 2,
              D = 128) and decode (Sq = 1) shapes, a decode against a
              long cache (Sk = 8192), a ragged shape, a ring-cache decode
              with a window, the soft cap and a batch row whose keys are
              all empty (exactly 0); and the newer models' shapes:
              Whisper-base's encoder (B = 8, 1,500 keys, D = 64, every key
              visible) and cross-attention decode, DeepSeek-V2's MLA
              prefill (H = KV = 128, D = 192) and a short one (8 rows a
              head: the split decode's body at D 192), Kimi-K2's prefill
              and decode (64 heads on 8, D = 112: CUDA cores in both
              dtypes). Each line names the kernel's route
              (ops.plan: fma, mma_bf16, split_decode, split_decode_mma).
              Times the kernel, the plain version and torch's
              scaled_dot_product_attention (the library yardstick; never
              on the path) at the prefill and decode shapes, warm and with
              the L2 flushed (without and with a spin on the card after
              the flush), beside the bound (and its share of it). A bf16
              line also holds each output row within BF16_STEPS_TOL bf16
              steps at the row's own scale (ref.bf16_steps), beside
              FA_TOL.
  7. serve    the LLM serving path: serve_lm on StarCoder2-3B at full
              width and depth (30 layers, d_model 3072, random weights
              from a seed), B = 8, prompts of 1024, 32 generated tokens,
              in f32 and in bf16; the kernel must launch exactly
              num_layers x gen times in each run, and a profiled prefill
              and decode step must each launch, and hold on the device,
              exactly one flash_attention kernel a layer (a step whose
              device count is off is profiled once more on the same
              inputs and must be exact there). Then, on the same params and
              prompts, the kernel path against the plain path
              (attn_impl="reference"): the prefill's last logits and 8
              teacher-forced decode steps.
  8. serve parity  StarCoder2 SMOKE on the card and on the CPU from the
              same params: prefill plus 4 teacher-forced decode steps.
  9. ssm kernels  ssm_scan against its plain version on the card, f32
              and bf16 u: Falcon-Mamba-7B's prefill (B = 8, S = 1024,
              D_in = 8192, N = 16), decode (S = 1 from a carried state)
              and continuation (S = 100 from a carried state) shapes and
              the reference's ragged sweep shapes; the prefill, decode and
              ragged shapes also in the fused form the mixer calls (dt's
              bias and softplus and the gate by z inside the launch; z,
              and in f32 b and c, strided slices of one projection, as the
              mixer hands them over). Each line says whether y and h are
              bitwise equal to the plain version's. Times the kernel (warm
              and with the L2 flushed) and the plain version at the
              prefill and decode shapes, unfused and fused, beside the
              bound — which counts the exponentials (and the fused form's
              logarithms) on the SFU at the card's top SM clock. The
              kernels line's headline is the fused f32 prefill.
 10. serve ssm  serve_lm on Falcon-Mamba-7B at full width and depth (64
              layers, d_model 4096, random weights from a seed), B = 8,
              prompts of 1024, 32 generated tokens, in f32 and in bf16;
              ssm_scan must launch exactly num_layers x gen times in each
              run and flash_attention never. A profiled prefill and decode
              step, each with no eager softplus (log1p) op and one silu
              op a layer (the conv's; the gate's is in the scan), as torch
              ops and as device kernels (profiled once more where the
              device count is off), and the decode step's launches on a line of their own; then
              the kernel path against the plain path (ssm_impl=
              "reference") on the same params and prompts.
 11. serve ssm parity  Falcon-Mamba SMOKE on the card and on the CPU from
              the same params: prefill plus 4 teacher-forced decode steps.
 12. lm train  one client's local training at full width and depth:
              StarCoder2-3B in f32 (random weights from a seed), B = 2
              sequences of 1,024 tokens, 3 SGD steps through
              launch/steps.make_train_step(remat="full") (each layer
              recomputed in the backward); the loss must be finite and
              fall, and the training route (plain attention: neither
              kernel has a backward) must launch no flash_attention or
              ssm_scan kernel. Seconds a step, tokens/s, peak memory and
              the bound (8·N·tokens f32 FLOP at the f32 peak).
 12b. tp train  the same step tensor-parallel (--tp-worker): StarCoder2-3B
              at full width and depth, make_train_step(model_group=...)
              over 2 gloo ranks on one card (tp_layout: NCCL ranks on
              more), each rank stepping its shard; losses within 1e-4
              relative of lm train's steps (handed to the ranks, not
              run again) and every leaf within 1e-4 of its max |w| and
              within 1/100 of how far those steps moved it (its
              movement printed beside it); a rank's peak memory,
              bytes at rest, step seconds and its Megatron collectives'
              count and ms a step. On four cards also federated
              StarCoder2-3B at full width, K = 5 on (1 x 4), 2 rounds.
 12c. moe parallel  the MoE layer on the mesh (--moe-parallel-worker):
              DeepSeek-V2's full-width MoE layer tensor-parallel on
              (1 x 2) and expert-parallel on (2 x 1) over 2 gloo ranks
              of one card, each against one process's layer (output,
              aux, every leaf's gradient within 1e-4 of its max, the
              expert ids equal); Kimi-K2 SMOKE's federated run on the
              tensor-parallel route against the CPU; on four cards
              Kimi-K2 at full width and 2 layers, 3 steps on (1 x 4) TP
              against (2 x 2) EP (phase_moe_parallel).
 13. lm fl    the reference example's federated LM run at its own size
              (repro_torch.examples.federated_llm_pretraining without
              --tiny: ~101M params, 20 clients, 5 a round, FedDPC) for 4
              rounds on the trainer's defaults (the staging ring, async
              eval), the last profiled (idle share; kernel time by
              matmuls, elementwise and FedDPC); each round must launch
              feddpc_dots and feddpc_batched_epilogue once, and the losses
              must be the reference example's (JAX on the CPU) within
              1e-4 relative.
 14. serve vlm  serve_lm on LLaVA-NeXT-Mistral-7B at full width and
              depth (32 layers, d_model 4096, random weights), B = 8, a
              zero prefix of 576 patch embeddings and prompts of 1,024
              tokens, 32 generated, f32 and bf16 — as phase 7: 32 x 32
              flash_attention launches a run, the profiled steps, the
              kernel path against the plain path (f32 logits within 1e-3
              x max|logit|, bf16 top-1 >= 90 %).
 15. quickstart  repro_torch.examples.quickstart at its own size (LeNet5,
              15 rounds of 10 of 30 clients, FedAvg then FedDPC): FedDPC
              launches feddpc_dots and feddpc_batched_epilogue once a
              round, FedAvg none.
 16. lm parity  federated_llm_pretraining --tiny for 2 rounds on the card
              and on the CPU: losses and holdout NLLs within 1e-4
              relative.

 17. serve encdec  Whisper-base through phase 7's loop (serve_encdec):
              full width and depth (6 + 6 layers, d_model 512, 1,500
              random frames), B = 8, 32 tokens from BOS, f32 and bf16;
              flash_attention launches exactly 6 + 2 x 6 x 32 times (the
              encoder once, then a self- and a cross-attention call a
              decoder layer a step); the profiled encode and decode step;
              the kernel path against the plain path.
 18. serve moe  phase 7's loop on DeepSeek-V2 (MLA + MoE), Jamba-1.5
              (Mamba + attention + MoE) and Kimi-K2 (MoE; bf16 only) at
              full width, their depth cut to two layers (MOE_SERVE); the
              launches per step by layer kind (MLA's absorbed decode
              launches no kernel).
 19. whisper train  3 SGD steps of make_train_step on Whisper-base at full
              width (B = 8, 1,500 frames, 448 target tokens): the loss
              falls, no serving kernel launches; seconds a step beside the
              FLOP bound, peak memory.
 20. moe parity  DeepSeek-V2, Jamba and Kimi-K2 SMOKE and Whisper-base
              SMOKE on the card and on the CPU from the same params
              (logits within 1e-4 relative, expert assignments equal); the
              training CLI with --model deepseek-v2-236b on both; the bits
              that two identical full-width MoE calls differ in.
 21. serve batched  repro_torch.examples.serve_batched on the card, its
              launches counted.

Every profile opens and closes with PROFILE_PAD spin kernels (and closes
with a wait on the host), finished outside the profiled work and left out
of its counts and times: the profiler drops a profile's first device
events, more of them late in a long process, and now and then its last.
The pads seen at each end say whether the window held the work whole.

The last lines are the kernels' JSON summary (each row's launches on the
main path and, as rank_launches, on the async_ranks phase's ranks), the
nvidia-smi line and
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result. It imports torch and the port, nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import gc
import io
import itertools
import json
import math
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.bridge import (layout_of, tree_leaves,  # noqa: E402
                                tree_map)
from repro_torch.configs import paper_lenet5, paper_resnet18  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import projection as proj  # noqa: E402
from repro_torch.core.api import (AlgoConfig, ExecConfig,  # noqa: E402
                                  FederatedTrainer)
from repro_torch.core.baselines import FedDPCHyper  # noqa: E402
from repro_torch.core import async_engine  # noqa: E402
from repro_torch.core import jax_prng  # noqa: E402
from repro_torch.core.faults import (FaultPlan,  # noqa: E402
                                     corrupt_checkpoint)
from repro_torch.core.runtime import ExponentialRuntime  # noqa: E402
from repro_torch.core.samplers import (MarkovSampler,  # noqa: E402
                                       UniformSampler)
from repro_torch.examples import federated_llm_pretraining as llm_example  # noqa: E402,E501
from repro_torch.examples import quickstart as quickstart_example  # noqa: E402,E501
from repro_torch.examples import serve_batched as serve_batched_example  # noqa: E402,E501
from repro_torch.codec import make_codec  # noqa: E402
from repro_torch.ingest.datasets import CIFAR100Source  # noqa: E402
from repro_torch.ingest.images import (StreamingImageSource,  # noqa: E402
                                       build_federated_image_data)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.feddpc_project import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.int8_sr import ops as sr_ops  # noqa: E402
from repro_torch.kernels.int8_sr import ref as sr_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ss_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as ss_ref  # noqa: E402
from repro_torch.launch import distributed  # noqa: E402
from repro_torch.launch import steps as lm_steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.serve import serve_encdec, serve_lm  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import linear  # noqa: E402
from repro_torch.models.vision import (init_vision,  # noqa: E402
                                       vision_accuracy, vision_loss_fn)
from repro_torch.sharding.rules import edge_pieces  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

K_MAIN = 10
N_MAIN = 11_220_132                   # ResNet18-GN, 100 classes
RAGGED = [(1, 1_000_003), (3, 1_000_003), (1, 37), (3, 37)]
ETA_G = 0.02
# tolerances, kernel vs plain version on the same card:
#  dots — both sum in f32 in different orders; relative to the
#    Cauchy-Schwarz scale sqrt(<d,d><p,p>) (resp. the norm itself)
DOTS_RTOL = 1e-5
#  epilogue — same element-wise rounding (the kernel's _rn intrinsics);
#    the mean divides where torch multiplies by 1/K: about one ulp
EPI_ATOL = 1e-5
EPI_RTOL = 1e-5
# card vs CPU LeNet5 losses: conv/matmul algorithms and sum orders
# differ (TF32 off), and two rounds of SGD amplify them a little
PARITY_ATOL = 1e-3
# card vs CPU FedVARP table (LeNet5, 3 rounds under a deadline): its rows
# are client deltas, 3.0e-6 apart in the runs before this limit was set
TABLE_ATOL = 1e-5

SOURCE = "src/repro_torch/kernels/feddpc_project/csrc/feddpc_project.cu"
_TPU = "src/repro/kernels/feddpc_project/kernel.py"
REPLACES = {"feddpc_dots": f"{_TPU}:44",
            "feddpc_batched_epilogue": f"{_TPU}:118",
            "feddpc_buffer_fold": f"{_TPU}:197",
            "feddpc_dequant_batched_epilogue": f"{_TPU}:269",
            "feddpc_dequant_buffer_fold": f"{_TPU}:345",
            "feddpc_guard_dots": f"{_TPU}:79",
            "feddpc_fused_epilogue": f"{_TPU}:394"}
# the folds of the async and codec rounds: K = B rows, and a synthetic
# layout (ragged N = 1,000,003) whose leaves of 1-31 elements put leaf
# boundaries inside every column tile
FOLD_KS = (1, 10, 33)
SYNTH_NUMELS = (5, 31, 1, 17) * 4 + (2048, 7, 997_732)
# the FedDPC kernel templates (a ptxas or SASS name holds one)
FEDDPC_KERNEL_NAMES = ("dots_kernel", "fold_kernel", "epilogue_kernel",
                       "dequant_fold_kernel")
# no single PyTorch call computes any of these functions (the FedDPC seven
# and the selective scan)
LIBRARY_NONE = "no single PyTorch call computes this function"
# the guard's reduction pass: K rows of N, ResNet18-GN's N and a ragged one
GUARD_KS = (1, 10, 33)
GUARD_NS = (N_MAIN, 1_000_003)

# ---- the LLM serving path ----
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:82"
# dense bf16 tensor-core peak (NVIDIA data sheet, H100 SXM)
BF16_FLOP_PER_S = 989e12
# kernel vs plain version: the reference's kernel tolerances
# (tests/test_kernels.py) — f32 sums in other orders; bf16 outputs
# rounded from f32 values that differ in their last bits
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 4e-2}
# ... and in bf16 also per output row: max |got - want| in bf16 steps at
# the row's max |want| (f32 values that differ in their last bits round
# at most one step apart); FA_TOL alone is as large as a decode's outputs
BF16_STEPS_TOL = 2
SERVE_ARCH = "starcoder2-3b"
VLM_ARCH = "llava-next-mistral-7b"
SERVE_B, SERVE_PROMPT, SERVE_GEN = 8, 1024, 32
SERVE_STEPS = 8               # teacher-forced steps, kernel vs plain path
SMOKE_STEPS = 4               # ... and card vs CPU on the SMOKE config
SERVE_F32_RTOL = 1e-3         # kernel vs plain logits, relative to max |logit|
SERVE_BF16_TOP1 = 0.9         # kernel vs plain top-1 agreement in bf16
SMOKE_ATOL = 1e-4             # card vs CPU SMOKE logits, f32
# (label, B, Sq, Sk, H, KV, D, window, soft_cap, empty trailing slots,
#  position of the first query, a batch row with every slot empty[, every
#  key visible: queries at position Sk, keys at 0..Sk-1, as the
#  encoder-decoder's encoder and cross-attention call it])
FA_CASES = (
    ("prefill", 8, 1024, 1056, 24, 2, 128, 0, 0.0, 32, 0, False),
    ("decode", 8, 1, 1056, 24, 2, 128, 0, 0.0, 16, 1039, False),
    ("decode_long", 8, 1, 8192, 24, 2, 128, 0, 0.0, 16, 8175, False),
    ("ragged", 2, 100, 300, 8, 2, 64, 0, 0.0, 0, 200, False),
    ("ring_decode_window", 4, 1, 1056, 24, 2, 128, 128, 0.0, 32, 2999,
     False),
    ("soft_cap", 2, 256, 256, 24, 2, 128, 0, 30.0, 0, 0, False),
    ("all_empty_row", 3, 16, 200, 8, 2, 128, 0, 0.0, 0, 184, True),
    # Whisper-base's encoder over 1,500 frames and its cross-attention
    # decode; DeepSeek-V2's MLA prefill (D 192, V padded to it) and a short
    # one (8 rows a head: the split decode's tensor-core body at D 192);
    # Kimi-K2's GQA prefill and decode (D 112: CUDA cores in both dtypes)
    ("whisper_encoder", 8, 1500, 1500, 8, 8, 64, 0, 0.0, 0, 0, False, True),
    ("whisper_cross_decode", 8, 1, 1500, 8, 8, 64, 0, 0.0, 0, 0, False,
     True),
    ("mla_prefill", 8, 1024, 1024, 128, 128, 192, 0, 0.0, 0, 0, False),
    ("mla_short_prefill", 8, 8, 64, 128, 128, 192, 0, 0.0, 56, 0, False),
    ("kimi_prefill", 8, 1024, 1024, 64, 8, 112, 0, 0.0, 0, 0, False),
    ("kimi_decode", 8, 1, 1056, 64, 8, 112, 0, 0.0, 16, 1039, False),
)
FA_TIMED = ("prefill", "decode", "decode_long", "whisper_encoder",
            "whisper_cross_decode", "mla_prefill", "mla_short_prefill",
            "kimi_prefill", "kimi_decode")
# the flash-attention kernels' names (a profile's key contains one)
FA_KERNEL_NAMES = ("fa_fwd_kernel", "fa_mma_kernel", "fa_split_kernel",
                   "fa_split_mma_kernel")

# ---- the pure-SSM serving path ----
SS_SOURCE = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
SS_REPLACES = "src/repro/kernels/ssm_scan/kernel.py:65"
# kernel vs plain version: the reference's kernel tolerances
# (tests/test_kernels.py); the kernel rounds step for step as the plain
# version does, so each line also says whether they are bitwise equal
SS_TOL = {torch.float32: 2e-4, torch.bfloat16: 4e-2}
SS_H_TOL = 2e-4
SSM_ARCH = "falcon-mamba-7b"
# (label, B, S, D_in, N, a carried-in state h0)
SS_CASES = (
    ("prefill", 8, 1024, 8192, 16, False),
    ("decode", 8, 1, 8192, 16, True),
    ("continuation", 8, 100, 8192, 16, True),
    ("ragged", 2, 100, 96, 8, False),
    ("ragged_short", 1, 17, 64, 4, False),
)
SS_TIMED = ("prefill", "decode")
# ... also run in the fused form (dt_bias, dt_softplus, z)
SS_FUSED = ("prefill", "decode", "ragged")
# the ssm_scan kernels' names (a profile's key or a SASS function holds one)
SS_KERNEL_NAMES = ("ssm_scan_kernel", "ssm_step_kernel")
# the SFU's exponentials (MUFU.EX2): 16 per clock per SM on the H100's 132
# SMs (NVIDIA's arithmetic instruction throughput table, compute 9.0)
SFU_PER_CLOCK_PER_SM = 16
NUM_SMS = 132
# torch.profiler drops a profile's first device events, a count that grows
# with the profiles the process has taken (0 in a fresh process, ~45 late
# in a full smoke, whatever the wait before the first launch; now and then
# hundreds: a Jamba decode step lost 256 pads and half its kernels, then
# every kernel when profiled again), and now and then its last (a FedDPC
# round lost its last ~2,400 kernels, the fold's among them, and showed
# more busy time than its window). Each profile therefore opens with
# PROFILE_PAD tiny spin kernels and closes with PROFILE_PAD more and a
# wait of PROFILE_TAIL_S or PROFILE_STRETCH of the window, whichever is
# longer; all of it is synchronized apart from the profiled work and left
# out of every count and time. A step profiled once more waits and pads
# as PROFILE_RETRY says (seconds, spin kernels at each end).
PROFILE_PAD = 1024
PROFILE_TAIL_S = 0.02
PROFILE_STRETCH = 0.1
PROFILE_RETRY = (1.0, 8192)
PAD_KERNEL = "spin_kernel"

# ---- the int8_sr encode kernel (not a TPU kernel: XLA draws the noise in
# the reference) ----
SR_SOURCE = "src/repro_torch/kernels/int8_sr/csrc/int8_sr.cu"
SR_REPLACES = ("none: not a TPU kernel; the reference's draw is XLA's "
               "threefry, src/repro/codec/codecs.py:156")
SR_KS = (1, 10)
SR_RAGGED_KS = (3, 33)
# 32-bit integer adds, shifts, logic ops: 64 per clock per SM (NVIDIA's
# arithmetic instruction throughput table, compute 9.0)
INT32_PER_CLOCK_PER_SM = 64
# int32 operations an element: threefry2x32's 20 rounds (add, funnel
# shift, xor) and its 5 key injections (two adds each, the round constant
# folded), the key schedule's xor, the output xor, the counter (a wide
# multiply-add), the float's shift and or, and the leaf walk's compare
SR_INT32_OPS = 2 + 20 * 3 + 5 * 2 + 5 + 1 + 1 + 2 + 2 + 2


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 20, calls: int = 10):
    """(ms, one_call_ms), each the median over ``reps`` windows of the
    CUDA-event time per call, after warm-up: ``ms`` from windows of
    ``calls`` back-to-back calls — the queue stays full, so the host's
    launch path (checks, allocation, the ctypes call) hides behind the
    kernels — and ``one_call_ms`` from windows of one call, the host's
    launch path included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for n in (calls, 1):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / n)
        out.append(statistics.median(times))
    return tuple(out)


def cuda_ms_cold(fn, reps: int = 20, spin: bool = False):
    """Median CUDA-event time of one call that finds the 50 MB L2 cold: a
    256 MB memset is queued just before each window, so the host's launch
    path also hides behind it. With ``spin``, a 0.1 ms spin on the card
    follows the memset, so that the launch path hides on a slow host too
    (``ms_cold_spin``; ``ms_cold`` is without)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(200_000)         # ~0.1 ms at ~2 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, flop_per_s: float = F32_FLOP_PER_S,
             sfu_ops: float = 0, sfu_per_s: float = math.inf):
    """(ms, "bytes" | "operations"): the larger of the bytes over HBM and
    the operations — FLOPs at ``flop_per_s``, and special-function
    operations (exponentials) at ``sfu_per_s`` — over their peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / flop_per_s, sfu_ops / sfu_per_s)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _smi(query: str, fmt: str = "csv,noheader") -> str:
    """nvidia-smi's answer to ``--query-gpu=query`` for the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_build() -> str:
    """All four libraries at once: one nvcc per source, started
    together."""
    tic = time.perf_counter()
    mods = (ops, fa_ops, ss_ops, sr_ops)
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        futures = [pool.submit(mod.build) for mod in mods]
        paths = [f.result() for f in futures]
    seconds = time.perf_counter() - tic
    smi = _smi("name,power.limit")
    emit({"phase": "build", "libraries": [p.name for p in paths],
          "nvcc_seconds": dict(_build.build_seconds), "seconds": seconds,
          "nvidia_smi": smi, "max_sm_clock_mhz": _max_sm_clock_mhz(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    fd_lib = paths[mods.index(ops)]
    emit({"phase": "build_feddpc_project",
          "kernels": _ptxas_report(fd_lib.with_suffix(".log").read_text(),
                                   FEDDPC_KERNEL_NAMES)})
    fa_lib = paths[mods.index(fa_ops)]
    sass = subprocess.run([_build.tool("cuobjdump"), "-sass", str(fa_lib)],
                          capture_output=True, text=True,
                          check=True).stdout
    hmma = sum("HMMA" in line for line in sass.splitlines())
    emit({"phase": "build_flash_attention",
          "kernels": _ptxas_report(fa_lib.with_suffix(".log").read_text()),
          "hmma_instructions": hmma})
    if hmma == 0:
        raise AssertionError("the flash-attention library holds no tensor-"
                             "core (HMMA) instruction")
    ss_lib = paths[mods.index(ss_ops)]
    emit({"phase": "build_ssm_scan",
          "kernels": ssm_sass_report(ss_lib, _max_sm_clock_mhz())})
    sr_lib = paths[mods.index(sr_ops)]
    emit({"phase": "build_int8_sr",
          "kernels": _ptxas_report(sr_lib.with_suffix(".log").read_text(),
                                   ("int8_sr_kernel",))})
    return smi


def _kernel_name(mangled: str, names):
    """kernel<mangled template arguments> for the longest of ``names``
    that ``mangled`` holds, or None."""
    base = max((n for n in names if n in mangled), key=len, default=None)
    if base is None:
        return None
    rest = mangled.split(base, 1)[1]
    # the arguments end where the nested name and the signature begin
    args = rest[:rest.index("EEv")].rstrip("E") if "EEv" in rest else rest
    return f"{base}<{args}>"


def _ptxas_report(log: str, names=FA_KERNEL_NAMES) -> dict:
    """kernel<template arguments> -> registers and spill bytes, from nvcc
    -Xptxas -v's output, for the kernels named in ``names``."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = _kernel_name(line.split("'")[1], names)
            if name is not None:
                out[name] = {}
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[name]["spill_store_bytes"] = nums[1]
            out[name]["spill_load_bytes"] = nums[2]
        elif name and "Used" in line and "registers" in line:
            words = line.split()
            out[name]["registers"] = int(words[words.index("Used") + 1])
    return out


_SASS_ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_BRA = re.compile(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
FP32_PIPE = ("FFMA", "FMUL", "FADD", "FMNMX")


def _sass_functions(sass: str, names) -> dict:
    """kernel<template arguments> -> {"ins": [(address, text)], "labels":
    {label: address}} for the SASS functions named in ``names``."""
    out, fn, pending = {}, None, []
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_name(line.split("Function :")[1].strip(), names)
            fn = (None if name is None
                  else out.setdefault(name, {"ins": [], "labels": {}}))
            pending = []
            continue
        if fn is None:
            continue
        lab = _SASS_LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _SASS_ADDR.search(line)
        if m:
            addr = int(m.group(1), 16)
            fn["labels"].update({lab: addr for lab in pending})
            pending = []
            fn["ins"].append((addr, m.group(2).strip()))
    return out


def _opcode(text: str) -> str:
    words = [w for w in text.split() if not w.startswith("@")]
    return words[0] if words else ""


def _sass_mix(ins) -> dict:
    """Instruction counts by opcode (MUFU by its function), the FP32 pipe's
    (FFMA, FMUL, FADD, FMNMX) and all."""
    counts = collections.Counter()
    for _, text in ins:
        op = _opcode(text)
        base = op.split(".")[0]
        counts[op if base == "MUFU" else base] += 1
    counts["fp32_pipe"] = sum(counts[k] for k in FP32_PIPE)
    counts["total"] = len(ins)
    return dict(counts)


def _hot_loop(fn) -> list:
    """The backward-branch range of ``fn`` that holds the state
    exponentials: of the loops whose only MUFU is EX2 (the softplus's log
    and the gate's reciprocal live in other loops), the one with the most
    of them, the shortest on a tie; [] when there is none."""
    best, key = [], None
    for addr, text in fn["ins"]:
        m = _SASS_BRA.search(text)
        if not m:
            continue
        tgt = (fn["labels"].get(m.group(1)) if m.group(1)
               else int(m.group(2), 16))
        if tgt is None or tgt > addr:
            continue
        body = [(a, t) for a, t in fn["ins"] if tgt <= a <= addr]
        ops = [_opcode(t) for _, t in body]
        mufu = {op for op in ops if op.startswith("MUFU")}
        if mufu != {"MUFU.EX2"}:
            continue
        k = (ops.count("MUFU.EX2"), -len(body))
        if key is None or k > key:
            best, key = body, k
    return best


def ssm_sass_report(lib, clock_mhz: float) -> dict:
    """Per ssm_scan kernel instance: ptxas's registers and spills, its
    SASS instruction mix (whole and hot loop) and, per state step (one
    exponential in the hot loop), the FP32-pipe and all instructions and
    the time they take at the prefill shape (B 8 x S 1024 x D_in 8192 x N
    16 state steps) over 132 SMs x 128 FP32 lanes, and x 4 warp issues, a
    clock at ``clock_mhz``."""
    lib = str(lib)
    log = Path(os.path.splitext(lib)[0] + ".log").read_text()
    ptxas = _ptxas_report(log, SS_KERNEL_NAMES)
    sass = subprocess.run([_build.tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    steps = 8 * 1024 * 8192 * 16
    per_clock = NUM_SMS * 128 * clock_mhz * 1e6
    out = {}
    for name, fn in _sass_functions(sass, SS_KERNEL_NAMES).items():
        loop = _sass_mix(_hot_loop(fn))
        row = {**ptxas.get(name, {}), "function": _sass_mix(fn["ins"]),
               "hot_loop": loop}
        ex2 = loop.get("MUFU.EX2", 0)
        if ex2:
            row.update({
                "fp32_per_state_step": loop["fp32_pipe"] / ex2,
                "instructions_per_state_step": loop["total"] / ex2,
                "fp32_issue_ms_at_prefill":
                    1e3 * steps * loop["fp32_pipe"] / ex2 / per_clock,
                "issue_ms_at_prefill":
                    1e3 * steps * loop["total"] / ex2 / per_clock})
        out[name] = row
    return out


def _max_sm_clock_mhz() -> float:
    return float(_smi("clocks.max.sm", "csv,noheader,nounits"))


def _inputs(gen, k, n, zero_prev):
    d = torch.randn((k, n), generator=gen, device="cuda")
    p = (torch.zeros(n, device="cuda") if zero_prev
         else torch.randn(n, generator=gen, device="cuda"))
    w = torch.randn(n, generator=gen, device="cuda")
    return d, p, w


def check_case(gen, k, n, zero_prev):
    """One shape: both kernels against their plain versions. Returns the
    max abs errors and the inputs (for timing)."""
    d, p, w = _inputs(gen, k, n, zero_prev)
    dots_k = ops.feddpc_dots(d, p)
    dots_r = ref.dots_ref(d, p)
    scale = torch.stack([torch.sqrt(dots_r[:, 1] * dots_r[:, 2]),
                         dots_r[:, 1], dots_r[:, 2]], -1).clamp(min=1.0)
    rel = float(((dots_k - dots_r).abs() / scale).max())
    if not rel <= DOTS_RTOL:
        raise AssertionError(f"feddpc_dots K={k} N={n} zero_prev="
                             f"{zero_prev}: rel err {rel} > {DOTS_RTOL}")
    coefs, scales, _ = proj.scalars_from_dots(
        dots_k[:, 0], dots_k[:, 1], dots_k[:, 2], 1.0)
    if zero_prev and not bool((coefs == 0).all()):
        raise AssertionError("round 1 (Delta_prev = 0): coef must be 0")
    w_k, dt_k = ops.feddpc_batched_epilogue(d, p, w, coefs, scales, ETA_G)
    w_r, dt_r = ref.batched_epilogue_ref(d, p, w, coefs, scales, ETA_G)
    for name, a, b in (("delta_t", dt_k, dt_r), ("w", w_k, w_r)):
        if not torch.allclose(a, b, rtol=EPI_RTOL, atol=EPI_ATOL):
            raise AssertionError(
                f"feddpc_batched_epilogue K={k} N={n} {name}: max abs err "
                f"{float((a - b).abs().max())}")
    torch.cuda.synchronize()
    err_dots = float((dots_k - dots_r).abs().max())
    err_epi = max(float((dt_k - dt_r).abs().max()),
                  float((w_k - w_r).abs().max()))
    emit({"phase": "kernels", "K": k, "N": n, "zero_prev": zero_prev,
          "dots_max_abs_err": err_dots, "dots_max_rel_err": rel,
          "epilogue_max_abs_err": err_epi})
    return err_dots, err_epi, (d, p, w, coefs, scales)


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"feddpc_dots": 0.0, "feddpc_batched_epilogue": 0.0}
    main_inputs = None
    for k, n in [(K_MAIN, N_MAIN)] + RAGGED:
        for zero_prev in (False, True):
            e_dots, e_epi, inputs = check_case(gen, k, n, zero_prev)
            err["feddpc_dots"] = max(err["feddpc_dots"], e_dots)
            err["feddpc_batched_epilogue"] = max(
                err["feddpc_batched_epilogue"], e_epi)
            if (k, n, zero_prev) == (K_MAIN, N_MAIN, False):
                main_inputs = inputs
    d, p, w, coefs, scales = main_inputs
    k, n = d.shape
    g = ops.dots_num_blocks(n)             # the dots kernel's partials
    dots_bytes = 4 * ((k + 1) * n + 3 * k * g)
    dots_flops = 4 * k * n + 2 * n
    epi_bytes, epi_flops = _fold_bytes_flops(k, n, False, False)
    rows = []
    for name, kern, plain, nbytes, flops in (
            ("feddpc_dots", lambda: ops.feddpc_dots(d, p),
             lambda: ref.dots_ref(d, p), dots_bytes, dots_flops),
            ("feddpc_batched_epilogue",
             lambda: ops.feddpc_batched_epilogue(d, p, w, coefs, scales,
                                                 ETA_G),
             lambda: ref.batched_epilogue_ref(d, p, w, coefs, scales,
                                              ETA_G), epi_bytes, epi_flops)):
        ms, ms_one = cuda_ms(kern)
        plain_ms, _ = cuda_ms(plain)
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name], "max_abs_err": err[name],
                     "ms": ms, "ms_one_call": ms_one, "plain_ms": plain_ms,
                     "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "library": LIBRARY_NONE,
                     "K": k, "N": n, "bytes": nbytes, "flops": flops})
        emit({"phase": "timing", **rows[-1]})
    return rows


def _guard_rows(gen, k, n):
    """(k, n) on the card, row j of kind j % 4 in (scattered NaN/+-Inf,
    clean, all NaN, scaled by 1e12) — K = 1 is the scattered row."""
    d = torch.randn((k, n), generator=gen, device="cuda")
    bad = torch.tensor([float("nan"), float("inf"), float("-inf")] * 3,
                       device="cuda")
    for j in range(k):
        kind = j % 4
        if kind == 0:
            at = torch.randint(0, n, (bad.numel(),), generator=gen,
                               device="cuda")
            d[j, at] = bad
        elif kind == 2:
            d[j] = float("nan")
        elif kind == 3:
            d[j] *= 1e12
    return d


def _check_guard(name, got, want, with_p):
    """Exact counts, dots within DOTS_RTOL of their Cauchy-Schwarz scale;
    returns (max abs err over the rows not scaled by 1e12 — theirs are
    ~1e31, where one f32 step is ~1e24 —, max rel err over all rows)."""
    if not torch.equal(got[:, 3], want[:, 3]):
        raise AssertionError(f"{name}: non-finite counts "
                             f"{got[:, 3].tolist()} != {want[:, 3].tolist()}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite dots")
    scale = torch.stack([torch.sqrt(want[:, 1] * want[:, 2]), want[:, 1],
                         want[:, 2]], -1).clamp(min=1.0)
    rel = float(((got[:, :3] - want[:, :3]).abs() / scale).max())
    if not rel <= DOTS_RTOL:
        raise AssertionError(f"{name}: rel err {rel} > {DOTS_RTOL}")
    if not with_p and not bool((got[:, [0, 2]] == 0).all()):
        raise AssertionError(f"{name}: without p, columns 0 and 2 must be 0")
    plain_rows = want[:, 1] < 1e20
    err = (float((got - want)[plain_rows].abs().max())
           if bool(plain_rows.any()) else 0.0)
    return err, rel


def _epilogue_bytes_flops(n, itemsize):
    # d read, out written in d's type; p read in f32; coef, scale
    return 2 * itemsize * n + 4 * n + 8, 3 * n


def phase_guard_epilogue():
    """The guard's reduction pass and the one-client epilogue against
    their plain versions at every listed shape, then timed at the main
    path's shape; returns their timing rows."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    err = {"feddpc_guard_dots": 0.0, "feddpc_fused_epilogue": 0.0}
    for k, n in itertools.product(GUARD_KS, GUARD_NS):
        d = _guard_rows(gen, k, n)
        for zero_prev in (False, True):
            p = (torch.zeros(n, device="cuda") if zero_prev
                 else torch.randn(n, generator=gen, device="cuda"))
            line = {"phase": "kernels", "kernel": "feddpc_guard_dots",
                    "K": k, "N": n, "zero_prev": zero_prev}
            for with_p in (True, False):
                pv = p if with_p else None
                got, want = ops.feddpc_guard_dots(d, pv), \
                    ref.guard_dots_ref(d, pv)
                torch.cuda.synchronize()
                e, rel = _check_guard(f"feddpc_guard_dots K={k} N={n} "
                                      f"with_p={with_p} zero_prev="
                                      f"{zero_prev}", got, want, with_p)
                err["feddpc_guard_dots"] = max(err["feddpc_guard_dots"], e)
                tag = "with_p" if with_p else "without_p"
                line[f"{tag}_max_abs_err"] = e
                line[f"{tag}_max_rel_err"] = rel
            line["nonfinite"] = got[:, 3].tolist()[:4]
            emit(line)
        del d
    for n, dtype, zero_prev in itertools.product(
            (N_MAIN, 1_000_003, 37), (torch.float32, torch.bfloat16),
            (False, True)):
        d = torch.randn(n, generator=gen, device="cuda").to(dtype)
        p = (torch.zeros(n, device="cuda") if zero_prev
             else torch.randn(n, generator=gen, device="cuda"))
        coef = torch.randn(1, generator=gen, device="cuda")
        scale = 1.0 + torch.rand(1, generator=gen, device="cuda")
        got = ops.feddpc_fused_epilogue(d, p, coef, scale)
        want = ref.epilogue_ref(d, p, coef, scale)
        torch.cuda.synchronize()
        # the same three f32 roundings, then the same cast
        if got.dtype != dtype or not torch.allclose(
                got.float(), want.float(), rtol=EPI_RTOL, atol=EPI_ATOL):
            raise AssertionError(
                f"feddpc_fused_epilogue N={n} {dtype}: max abs err "
                f"{float((got.float() - want.float()).abs().max())}")
        e = float((got.float() - want.float()).abs().max())
        err["feddpc_fused_epilogue"] = max(err["feddpc_fused_epilogue"], e)
        emit({"phase": "kernels", "kernel": "feddpc_fused_epilogue", "N": n,
              "dtype": str(dtype).replace("torch.", ""),
              "zero_prev": zero_prev, "max_abs_err": e})
    # timing at the main path's shapes, on clean rows
    k, n = K_MAIN, N_MAIN
    d = torch.randn((k, n), generator=gen, device="cuda")
    p = torch.randn(n, generator=gen, device="cuda")
    g = ops.dots_num_blocks(n)
    coef = torch.randn(1, generator=gen, device="cuda")
    scale = 1.0 + torch.rand(1, generator=gen, device="cuda")
    cases = [
        # (name, form, kernel, plain, bytes, flops): the guard's route
        # (no p) first — it is the main path's form
        ("feddpc_guard_dots", "without_p",
         lambda: ops.feddpc_guard_dots(d),
         lambda: ref.guard_dots_ref(d), 4 * (k * n + 4 * k * g),
         3 * k * n),
        ("feddpc_guard_dots", "with_p",
         lambda: ops.feddpc_guard_dots(d, p),
         lambda: ref.guard_dots_ref(d, p),
         4 * ((k + 1) * n + 4 * k * g), 5 * k * n + 2 * n)]
    for dtype in (torch.float32, torch.bfloat16):
        d1 = d[0].to(dtype)
        cases.append(("feddpc_fused_epilogue", str(dtype).replace(
            "torch.", ""),
            lambda d1=d1: ops.feddpc_fused_epilogue(d1, p, coef, scale),
            lambda d1=d1: ref.epilogue_ref(d1, p, coef, scale),
            *_epilogue_bytes_flops(n, d1.element_size())))
    rows = {}
    for name, form, kern, plain, nbytes, flops in cases:
        ms, ms_one = cuda_ms(kern)
        plain_ms, _ = cuda_ms(plain)
        b_ms, b_by = bound_ms(nbytes, flops)
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "max_abs_err": err[name],
               "ms": ms, "ms_one_call": ms_one, "plain_ms": plain_ms,
               "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None, "library": LIBRARY_NONE,
               "form": form, "K": 1 if name == "feddpc_fused_epilogue"
               else k, "N": n, "bytes": nbytes, "flops": flops}
        emit({"phase": "timing", **row})
        rows.setdefault(name, row)      # the main path's form
    return list(rows.values())


def phase_project_and_scale():
    """projection.project_and_scale(use_kernel=True) on one ResNet18-GN-
    sized flat delta: the launch counts are set to 0 just before the call
    and read just after; the result is held against the same call on the
    CPU. Returns the launch counts."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    delta = torch.randn(N_MAIN, generator=gen, device="cuda")
    prev = torch.randn(N_MAIN, generator=gen, device="cuda")
    ops.reset_launches()                   # this path starts here
    scaled, diag = proj.project_and_scale(delta, prev, 1.0, use_kernel=True)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    want = {k: int(k == "feddpc_fused_epilogue") for k in launches}
    if launches != want:
        raise AssertionError(f"project_and_scale launches {launches}, "
                             f"expected {want}")
    c_scaled, c_diag = proj.project_and_scale(delta.cpu(), prev.cpu(), 1.0,
                                              use_kernel=True)
    # scalars from f32 sums in other orders (card vs CPU): ~1e-6 relative
    err = float((scaled.cpu() - c_scaled).abs().max())
    tol = 1e-5 * float(c_scaled.abs().max())
    if not err <= tol:
        raise AssertionError(f"project_and_scale card vs CPU: {err} > {tol}")
    flat = ops.project_and_scale_flat(delta, prev, 1.0)
    flat_ref = ref.project_and_scale_flat_ref(delta, prev, 1.0)
    torch.cuda.synchronize()
    err_flat = float((flat - flat_ref).abs().max())
    if not err_flat <= tol:
        raise AssertionError(f"project_and_scale_flat: {err_flat} > {tol}")
    emit({"phase": "project", "N": N_MAIN, "launches": launches,
          "scale": float(diag["scale"]), "coef": float(diag["coef"]),
          "card_vs_cpu_max_abs_err": err,
          "flat_vs_plain_max_abs_err": err_flat})
    return launches


@functools.lru_cache(maxsize=None)
def _init(cfg):
    """The reference's initial params for ``cfg`` (PRNGKey(0)): 11.2 M
    normals on the host at ResNet18-GN's width, drawn once; every trainer
    copies them into its own flat buffer."""
    return init_vision(cfg, jax_prng.PRNGKey(0))


def _resnet18_offsets():
    return layout_of(_init(paper_resnet18.CONFIG)).leaf_offsets


def _payload(gen, k, offsets, qdtype):
    """A codec payload on the card: int8 codes in [-127, 127] or bf16
    values, per-leaf scales and zero-points."""
    n, nleaves = int(offsets[-1]), offsets.numel() - 1
    if qdtype == torch.int8:
        q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
    else:
        q = torch.randn((k, n), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
    qscale = torch.rand((k, nleaves), generator=gen, device="cuda") * 0.02
    qzero = torch.randn((k, nleaves), generator=gen, device="cuda") * 0.1
    return q, qscale, qzero


def _fold_calls(q, qscale, qzero, offsets, p, w, coefs, scales, wgts):
    """{kernel name: (kernel call, plain call)} for the three folds; the
    buffered fold reads the dequantized payload as its f32 stack."""
    d = ref.dequant_ref(q, qscale, qzero, offsets)
    args = (q, qscale, qzero, offsets, p, w, coefs, scales)
    return {
        "feddpc_buffer_fold": (
            lambda: ops.feddpc_buffer_fold(d, p, w, coefs, scales, wgts,
                                           ETA_G),
            lambda: ref.buffer_fold_ref(d, p, w, coefs, scales, wgts,
                                        ETA_G)),
        "feddpc_dequant_batched_epilogue": (
            lambda: ops.feddpc_dequant_batched_epilogue(*args, ETA_G),
            lambda: ref.dequant_batched_epilogue_ref(*args, ETA_G)),
        "feddpc_dequant_buffer_fold": (
            lambda: ops.feddpc_dequant_buffer_fold(*args, wgts, ETA_G),
            lambda: ref.dequant_buffer_fold_ref(*args, wgts, ETA_G)),
    }


def _fold_inputs(gen, k, offsets, qdtype):
    n = int(offsets[-1])
    q, qscale, qzero = _payload(gen, k, offsets, qdtype)
    p = torch.randn(n, generator=gen, device="cuda")
    w = torch.randn(n, generator=gen, device="cuda")
    coefs = torch.randn(k, generator=gen, device="cuda")
    scales = 1.0 + torch.rand(k, generator=gen, device="cuda")
    wgts = torch.linspace(0.3, 1.0, k, device="cuda")
    return q, qscale, qzero, offsets, p, w, coefs, scales, wgts


def _fold_bytes_flops(k, n, dequant, weighted, nleaves=0, itemsize=4):
    """Bytes each input read once and each output written once, and the
    f32 operations, of one fold launch over k rows of n columns."""
    nbytes = (k * n * itemsize + 4 * 4 * n        # d or q; p, w, w', dt
              + 4 * (2 + weighted) * k)           # coefs, scales, wgts
    flops = (6 if dequant else 4) * k * n + 3 * n + weighted * k
    if dequant:
        nbytes += 4 * 2 * k * nleaves + 8 * (nleaves + 1)
    return nbytes, flops


def phase_folds():
    """The three folds against their plain versions at every listed
    shape; returns {name: max abs err} and the timing rows."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    layouts = {"resnet18": _resnet18_offsets(),
               "synthetic": torch.tensor(
                   [0] + list(itertools.accumulate(SYNTH_NUMELS)),
                   dtype=torch.int64)}
    if int(layouts["resnet18"][-1]) != N_MAIN:
        raise AssertionError("ResNet18-GN layout does not hold N_MAIN")
    err = {}
    for (lname, offsets), k, qdtype in itertools.product(
            layouts.items(), FOLD_KS, (torch.int8, torch.bfloat16)):
        calls = _fold_calls(*_fold_inputs(gen, k, offsets, qdtype))
        line = {"phase": "kernels", "layout": lname, "K": k,
                "N": int(offsets[-1]), "leaves": offsets.numel() - 1,
                "payload": str(qdtype).replace("torch.", "")}
        for name, (kern, plain) in calls.items():
            (w_k, dt_k), (w_r, dt_r) = kern(), plain()
            torch.cuda.synchronize()
            for what, a, b in (("delta_t", dt_k, dt_r), ("w", w_k, w_r)):
                if not torch.allclose(a, b, rtol=EPI_RTOL, atol=EPI_ATOL):
                    raise AssertionError(
                        f"{name} {line}: {what} max abs err "
                        f"{float((a - b).abs().max())}")
            e = max(float((dt_k - dt_r).abs().max()),
                    float((w_k - w_r).abs().max()))
            err[name] = max(err.get(name, 0.0), e)
            line[f"{name}_max_abs_err"] = e
        emit(line)
    rows = {}
    offsets = layouts["resnet18"]
    for qdtype in (torch.int8, torch.bfloat16):
        inputs = _fold_inputs(gen, K_MAIN, offsets, qdtype)
        for name, (kern, plain) in _fold_calls(*inputs).items():
            if name == "feddpc_buffer_fold" and qdtype != torch.int8:
                continue            # reads f32: one timing is enough
            dequant = name != "feddpc_buffer_fold"
            nbytes, flops = _fold_bytes_flops(
                K_MAIN, N_MAIN, dequant,
                name != "feddpc_dequant_batched_epilogue",
                offsets.numel() - 1,
                inputs[0].element_size() if dequant else 4)
            ms, ms_one = cuda_ms(kern)
            plain_ms, _ = cuda_ms(plain)
            b_ms, b_by = bound_ms(nbytes, flops)
            row = {"name": name, "route": "cuda", "source": SOURCE,
                   "replaces": REPLACES[name], "max_abs_err": err[name],
                   "ms": ms, "ms_one_call": ms_one,
                   "ms_cold_spin": cuda_ms_cold(kern, spin=True),
                   "plain_ms": plain_ms, "bound_ms": b_ms,
                   "pct_of_bound": 100.0 * b_ms / ms,
                   "bound_by": b_by, "library_ms": None,
                   "library": LIBRARY_NONE, "K": K_MAIN, "N": N_MAIN,
                   "payload": ("float32" if name == "feddpc_buffer_fold"
                               else str(qdtype).replace("torch.", "")),
                   "bytes": nbytes, "flops": flops}
            emit({"phase": "timing", **row})
            # the main path ships int8: its time stands in the summary
            if qdtype == torch.int8:
                rows[name] = row
        del inputs
    return list(rows.values())


def _sr_inputs(gen, k, offsets, t):
    """int8_sr's inputs as the codec hands them to the kernel: (K, N)
    deltas on the card, their symmetric per-leaf scales, and the per-leaf
    keys of round t from PRNGKey(0)."""
    x = torch.randn((k, int(offsets[-1])), generator=gen,
                    device="cuda") * 0.01
    scale, _ = make_codec("int8_sr")._leaf_scalars(x, offsets)
    keys = jax_prng.fold_in_many(jax_prng.fold_in(jax_prng.PRNGKey(0), t),
                                 np.arange(offsets.numel() - 1))
    return x, scale, offsets, keys


def _sr_plain(x, scale, offsets, keys, partitionable=True, row0=0,
              rows_total=None, leaf_blocks=None):
    return sr_ref.int8_sr_quantize_ref(
        x, scale, offsets, torch.from_numpy(keys.astype(np.int64)),
        partitionable, row0, rows_total, leaf_blocks)


def _sr_bytes_ops(k, n, nleaves):
    """x read and q written once, the scales, offsets and keys; the int32
    operations of the draw (SR_INT32_OPS an element)."""
    return (5 * k * n + 4 * k * nleaves + 8 * (nleaves + 1) + 8 * nleaves,
            SR_INT32_OPS * k * n)


def phase_int8_sr():
    """int8_sr_quantize bit for bit against its plain version at every
    listed shape and in both counter layouts; the plain version's uniforms
    against jax_prng's numpy draw on one full leaf; then timed at K = 10,
    N = 11,220,132. Returns its timing row."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    layouts = {"resnet18": _resnet18_offsets(),
               "synthetic": torch.tensor(
                   [0] + list(itertools.accumulate(SYNTH_NUMELS)),
                   dtype=torch.int64)}
    cases = [("resnet18", k) for k in SR_KS] + \
        [("synthetic", k) for k in SR_RAGGED_KS]
    for (lname, k), part in itertools.product(cases, (True, False)):
        x, scale, offsets, keys = _sr_inputs(gen, k, layouts[lname], k)
        got = sr_ops.int8_sr_quantize(x, scale, offsets, keys, part)
        want = _sr_plain(x, scale, offsets, keys, part)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        emit({"phase": "kernels", "kernel": "int8_sr_quantize",
              "layout": lname, "K": k, "N": int(offsets[-1]),
              "leaves": offsets.numel() - 1, "partitionable": part,
              "mismatches": bad, "bitwise_equal": bad == 0,
              "codes_at_127": int((got.abs() == 127).sum())})
        if bad:
            raise AssertionError(f"int8_sr_quantize {lname} K={k} "
                                 f"partitionable={part}: {bad} codes differ "
                                 "from the plain version")
        del x, scale, got, want
    # a rank's block: rows 5-9 of a 10-row stack, and model rank
    # 1's shard of ResNet18-GN's leaves on a (2 x 2) mesh (whole-leaf
    # counters through the leaves' slice descriptors), both counter
    # layouts
    # imported here: tools/*_report.py --src load older trees' packages
    from repro_torch.sharding.layout import ShardLayout
    shards = ShardLayout.from_sizes(layout_of(_init(paper_resnet18.CONFIG)),
                                    {"clients": 2, "model": 2})
    whole = layouts["resnet18"]
    for model, part in itertools.product((False, True), (True, False)):
        m = 1
        offsets = shards.offsets(m) if model else whole
        x, scale, _, keys = _sr_inputs(gen, 5, offsets, 7)
        block = {"row0": 5, "rows_total": 10}
        if model:
            keys = jax_prng.fold_in_many(
                jax_prng.fold_in(jax_prng.PRNGKey(0), 7), shards.leaf_ids(m))
            block["leaf_blocks"] = shards.leaf_blocks(m)
        got = sr_ops.int8_sr_quantize(x, scale, offsets, keys, part,
                                      **block)
        want = _sr_plain(x, scale, offsets, keys, part, **block)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        emit({"phase": "kernels", "kernel": "int8_sr_quantize",
              "block": "model shard 1 of 2" if model else "rows 5-9 of 10",
              "K": 5, "N": int(offsets[-1]), "leaves": offsets.numel() - 1,
              "partitionable": part, "mismatches": bad,
              "bitwise_equal": bad == 0})
        if bad:
            raise AssertionError(f"int8_sr_quantize block (model={model}, "
                                 f"partitionable={part}): {bad} codes "
                                 "differ from the plain version")
        del x, scale, got, want
    # the plain version's noise is the reference's: its uniforms on the
    # largest ResNet18-GN leaf (two rows) against the numpy draw
    offsets = layouts["resnet18"]
    sizes = offsets[1:] - offsets[:-1]
    leaf = int(torch.argmax(sizes))
    numel = int(sizes[leaf])
    key = jax_prng.fold_in(jax_prng.fold_in(jax_prng.PRNGKey(0), 3), leaf)
    idx = (torch.arange(2, device="cuda")[:, None] * numel
           + torch.arange(numel, device="cuda"))
    u_plain = sr_ref.bits_to_unit_ref(sr_ref.draw_bits_ref(
        int(key[0]), int(key[1]), idx, 2 * numel, jax_prng.PARTITIONABLE))
    u_numpy = jax_prng.uniform(key, (2, numel))
    if not np.array_equal(u_plain.cpu().numpy().view(np.uint32),
                          u_numpy.view(np.uint32)):
        raise AssertionError("int8_sr's plain draw differs from jax_prng's "
                             f"on leaf {leaf}")
    emit({"phase": "kernels", "kernel": "int8_sr_quantize",
          "plain_vs_jax_prng_leaf": leaf, "elements": 2 * numel,
          "bitwise_equal": True})
    # timing at the main path's shape
    x, scale, offsets, keys = _sr_inputs(gen, K_MAIN, offsets, 0)
    k, n = x.shape
    nbytes, int_ops = _sr_bytes_ops(k, n, offsets.numel() - 1)
    clock_mhz = _max_sm_clock_mhz()
    int_per_s = INT32_PER_CLOCK_PER_SM * NUM_SMS * 1e6 * clock_mhz
    b_ms, b_by = bound_ms(nbytes, int_ops, flop_per_s=int_per_s)

    def kern():
        return sr_ops.int8_sr_quantize(x, scale, offsets, keys)
    err = float((kern().to(torch.int16)
                 - _sr_plain(x, scale, offsets, keys).to(torch.int16))
                .abs().max())
    if err != 0.0:
        raise AssertionError(f"int8_sr_quantize at the timed shape: codes "
                             f"differ from the plain version by {err}")
    ms, ms_one = cuda_ms(kern)
    plain_ms, _ = cuda_ms(lambda: _sr_plain(x, scale, offsets, keys),
                          reps=3, calls=1)
    row = {"name": "int8_sr_quantize", "route": "cuda", "source": SR_SOURCE,
           "replaces": SR_REPLACES, "max_abs_err": err, "ms": ms,
           "ms_one_call": ms_one,
           "ms_cold_spin": cuda_ms_cold(kern, spin=True),
           "plain_ms": plain_ms, "bound_ms": b_ms,
           "pct_of_bound": 100.0 * b_ms / ms, "bound_by": b_by,
           "library_ms": None, "library": LIBRARY_NONE, "K": k, "N": n,
           "bytes": nbytes, "int32_ops": int_ops,
           "int32_ops_per_element": SR_INT32_OPS,
           "max_sm_clock_mhz": clock_mhz}
    emit({"phase": "timing", **row})
    return row


def _image_task(cfg, num_classes, samples_per_class, test_per_class):
    data = build_federated_image_data(
        num_classes=num_classes, num_clients=30, alpha=0.2,
        samples_per_class=samples_per_class, test_per_class=test_per_class,
        seed=0)
    source = StreamingImageSource(data, batch_size=64)
    return data, source, functools.partial(vision_loss_fn, cfg)


def _trainer(cfg, data, source, loss_fn, params, name, rounds, device,
             exec_kw=None, runtime=None, fault_plan=None, sampler=None,
             resume_from=None):
    """A FederatedTrainer of the smoke's runs; with ``resume_from`` the
    same construction resumed from that checkpoint directory."""
    te_x = torch.from_numpy(data.test_images).to(device)
    te_y = torch.from_numpy(data.test_labels).to(device)
    algo = AlgoConfig(name=name, eta_l=0.02, eta_g=0.02,
                      hyper=FedDPCHyper(lam=1.0) if name == "feddpc"
                      else None)
    args = (loss_fn, params, data.num_clients, source,
            ExecConfig(**{"rounds": rounds, "clients_per_round": 10,
                          "seed": 0, "eval_every": 1, **(exec_kw or {})}),
            lambda p: vision_accuracy(cfg, p, te_x, te_y))
    kw = dict(algo=algo,
              sampler=sampler or UniformSampler(data.num_clients, 10),
              runtime=runtime, fault_plan=fault_plan, device=device)
    if resume_from is not None:
        return FederatedTrainer.resume(resume_from, *args, **kw)
    return FederatedTrainer(*args, **kw)


CODEC_CATEGORY = "codec encode/decode (plain PyTorch)"


def _category(kernel: str) -> str:
    if any(tag in kernel for tag in ("dots_kernel", "fold_kernel",
                                     "epilogue_kernel")):
        return "feddpc kernels"
    if "int8_sr_kernel" in kernel:
        return "int8_sr kernel"
    if any(tag in kernel for tag in ("cudnn", "xmma", "fft", "grad",
                                     "pointwise_mult_and_sum_complex")):
        return "convolutions (cuDNN)"
    if "at::native" in kernel:
        return "PyTorch elementwise and reductions"
    return "other"


def _annotate_codec(trainer):
    """Wrap the trainer's codec in profiler ranges, so the kernels its
    encode and decode launch can be told apart from training's."""
    codec = trainer._codec
    for meth in ("encode_cohort", "decode_cohort"):
        fn = getattr(codec, meth)

        def wrapped(*args, _fn=fn, _name=f"codec.{meth}", **kwargs):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kwargs)
        setattr(codec, meth, wrapped)


def _profile_lead(pads=PROFILE_PAD):
    """A profile's lead: ``pads`` spin kernels, finished before the
    profiled work is launched."""
    for _ in range(pads):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _profile_tail(window_s, wait_s=PROFILE_TAIL_S, pads=PROFILE_PAD):
    """A profile's tail, once its work of window_s has finished: ``pads``
    spin kernels, then a wait of wait_s or PROFILE_STRETCH of the window,
    whichever is longer."""
    for _ in range(pads):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()
    time.sleep(max(wait_s, PROFILE_STRETCH * window_s))


def _pads_seen(events) -> dict:
    """The spin kernels a profile shows before its first other device
    event ("lead") and after its last ("tail"), in the card's order; with
    no other device event, every pad seen counts as lead."""
    pads = [PAD_KERNEL in key for _, key in sorted(
        (e.time_range.start, e.key) for e in events
        if e.device_type == DeviceType.CUDA
        and not e.key.startswith("codec."))]
    if all(pads):
        return {"lead": len(pads), "tail": 0}
    return {"lead": pads.index(False),
            "tail": pads[::-1].index(False)}


def _kernel_time(events, category):
    """Device kernels of a profile, the pad kernels left out: (spans, busy
    µs — the union of their intervals —, ms by kernel name, ms by
    ``category(name)``)."""
    spans = sorted((e.time_range.start, e.time_range.end, e.key)
                   for e in events if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("codec.")
                   and PAD_KERNEL not in e.key)
    busy_us, end = 0.0, float("-inf")
    by_name, by_cat = {}, {}
    for lo, hi, name in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e3
        cat = category(name)
        by_cat[cat] = by_cat.get(cat, 0.0) + (hi - lo) / 1e3
    return spans, busy_us, by_name, by_cat


def profile_round(trainer, t, category=_category):
    """Run round t (and its eval) under torch.profiler: kernel time by
    name and by category, and the card's busy share of the window — the
    union of the kernels' intervals over the window's wall time. The
    previous round's eval lands before the window opens and this round's
    inside it (async eval runs it on a worker thread), so the window holds
    the round and its eval, as an inline eval's would. With a lossy codec
    the kernels launched inside its encode and decode are a category of
    their own. ``category`` names a kernel's category (the LM rounds'
    is ``_lm_category``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    trainer.finalize()
    with torch.profiler.profile(activities=acts) as prof:
        _profile_lead()
        tic = time.perf_counter()
        rec = trainer.run_round(t)
        trainer.finalize()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - tic
        _profile_tail(window_s)
    events = prof.events()
    pads = _pads_seen(events)
    spans, busy_us, by_name, by_cat = _kernel_time(events, category)
    # codec kernels: those launched by CPU ops inside a codec range
    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CPU
              and e.key.startswith("codec.")]
    codec_ms, codec_n = 0.0, 0
    for e in events:
        if (e.device_type != DeviceType.CPU or e.key.startswith("codec.")
                or not any(lo <= e.time_range.start <= hi
                           for lo, hi in ranges)):
            continue
        for k in e.kernels:
            ms = k.duration / 1e3
            cat = _category(k.name)
            by_cat[cat] = by_cat.get(cat, 0.0) - ms
            codec_ms += ms
            codec_n += 1
    if ranges:
        by_cat[CODEC_CATEGORY] = codec_ms
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    line = {"phase": "profile", "round": t, "round_seconds": rec.seconds,
            "window_seconds": window_s, "kernels": len(spans),
            "lead_pads_seen": pads["lead"], "tail_pads_seen": pads["tail"],
            "kernel_sum_ms": sum(by_name.values()),
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / window_s,
            "by_category_ms": by_cat, "codec_kernels": codec_n,
            "feddpc_kernels_ms": {k: v for k, v in by_name.items()
                                  if category(k) == "feddpc kernels"},
            "top_ms": [[name[:70], ms] for name, ms in top]}
    emit(line)
    return rec, line


# the chaos runs: the update guard, a round deadline of 2.0 virtual
# seconds under exponential latencies (mean 1), and a seeded fault plan
# of NaN deltas (10 % of the clients in every round) and deltas exploded
# by 1e12 (10 %) once the guard has warmed up (+inf threshold until 8
# norms are accepted: an explosion before that goes through, by design).
# Sync round 0 accepts 8 norms, so explosions start in round 1. Async
# round 0 folds arrivals of waves 0 and 1 (2 waves in flight), so there
# they start with wave 2.
CHAOS = {"guard": True, "round_deadline": 2.0}
SYNC_PLAN = {"nan_rate": 0.1, "explode_rate": 0.1,
             "explode_rounds": (1, 2, 3)}
ASYNC_PLAN = {"nan_rate": 0.1, "explode_rate": 0.1,
              "explode_rounds": (2, 3, 4, 5)}
PLAN_SEED = 0

# the trainer runs: (label, algorithm, ExecConfig overrides, exponential
# latencies?, rounds, kernels each round must launch once, fault plan)
ASYNC = {"async_buffer": True, "buffer_size": 10, "async_concurrency": 2}
ASYNC_INT8_EF = {**ASYNC, "codec": "int8", "codec_ef": True}
SYNC_KERNELS = ("feddpc_dots", "feddpc_batched_epilogue")
RUNS = (
    # the three staging regimes of sync FedDPC: the ring with device
    # staging (the defaults), host-staged, blocking staging
    ("feddpc", "feddpc", {}, False, 4, SYNC_KERNELS, None),
    ("feddpc_host_staged", "feddpc", {"device_stage": False}, False, 4,
     SYNC_KERNELS, None),
    ("feddpc_blocking", "feddpc", {"prefetch": False}, False, 4,
     SYNC_KERNELS, None),
    ("fedavg", "fedavg", {}, False, 3, (), None),
    ("feddpc_int8", "feddpc", {"codec": "int8"}, False, 4,
     ("feddpc_dots", "feddpc_dequant_batched_epilogue"), None),
    ("feddpc_async", "feddpc", ASYNC, True, 4,
     ("feddpc_dots", "feddpc_buffer_fold"), None),
    ("feddpc_async_int8_ef", "feddpc", ASYNC_INT8_EF, True, 4,
     ("feddpc_dots", "feddpc_dequant_buffer_fold"), None),
    # int8_sr: one int8_sr_quantize a round (a wave, async) besides
    ("feddpc_int8_sr", "feddpc", {"codec": "int8_sr"}, False, 4,
     ("feddpc_dots", "feddpc_dequant_batched_epilogue"), None),
    ("feddpc_async_int8_sr_ef", "feddpc",
     {**ASYNC, "codec": "int8_sr", "codec_ef": True}, True, 4,
     ("feddpc_dots", "feddpc_dequant_buffer_fold"), None),
    ("feddpc_chaos", "feddpc", CHAOS, True, 4,
     ("feddpc_guard_dots", "feddpc_dots", "feddpc_batched_epilogue"),
     SYNC_PLAN),
    # the guard rewrites rows after decode (and the faults before it), so
    # the fold reads the decoded f32 rows, not the int8 payload
    ("feddpc_async_int8_chaos", "feddpc", {**ASYNC_INT8_EF, **CHAOS}, True,
     6, ("feddpc_guard_dots", "feddpc_dots", "feddpc_buffer_fold"),
     ASYNC_PLAN),
    # the paper's baselines and ablations (Fig. 3 and 6) and the server
    # optimizers: the FedAvg family launches no FedDPC kernel; the
    # projection-only ablation, FedDPC-M (async: the buffer fold) and
    # FedDPC under FedAdam go through them
    ("fedprox", "fedprox", {}, False, 3, (), None),
    ("fedexp", "fedexp", {}, False, 3, (), None),
    ("fedga", "fedga", {}, False, 3, (), None),
    ("fedcm", "fedcm", {}, False, 3, (), None),
    ("fedvarp", "fedvarp", {}, False, 3, (), None),
    ("fedvarp_markov", "fedvarp", {}, False, 3, (), None),
    ("feddpc_noscale", "feddpc_noscale", {}, False, 3,
     ("feddpc_dots", "feddpc_batched_epilogue"), None),
    ("feddpc_m_async", "feddpc_m", ASYNC, True, 3,
     ("feddpc_dots", "feddpc_buffer_fold"), None),
    ("feddpc_fedadam", "feddpc", {"server_opt": "fedadam"}, False, 3,
     ("feddpc_dots", "feddpc_batched_epilogue"), None),
    ("fedyogi", "fedyogi", {}, False, 3, (), None),
)
# runs with another participation model than uniform
SAMPLERS = {"fedvarp_markov": lambda: MarkovSampler(30, 10, p_on=0.5,
                                                    p_off=0.5)}
PROFILED = ("feddpc", "feddpc_host_staged", "feddpc_blocking", "fedavg",
            "feddpc_async_int8_ef", "feddpc_int8_sr", "feddpc_chaos",
            "fedvarp")
STAGING = ("feddpc", "feddpc_host_staged", "feddpc_blocking")


def _expected_sync_quarantine(rounds, deadline, plan):
    """Per round, the plan's fault targets among the clients that arrive
    by the deadline — re-derived from a fresh sampler and runtime on the
    trainer's seed (the trainer's RNG stream, draw for draw)."""
    rng = np.random.RandomState(0)
    sampler = UniformSampler(30, 10)
    runtime = ExponentialRuntime(mean=1.0)
    out = []
    for t in range(rounds):
        clients = sampler.sample(rng, t)
        lat, dropped = runtime.draw(rng, t, clients)
        live = ~dropped & (lat + plan.latency_boost(t, clients) <= deadline)
        out.append(int((plan.delta_targets(t, clients) & live).sum()))
    return out


def _record_fold_targets(trainer):
    """Wrap the async engine's fold_extras: per fold, how many folded
    arrivals the plan targets (the rows the guard must quarantine)."""
    engine, counts = trainer._engine, []
    inner = engine.fold_extras

    def fold_extras(entries):
        out = inner(entries)
        counts.append(int((out[0] != 0).sum()))
        return out
    engine.fold_extras = fold_extras
    return counts


def phase_trainer():
    cfg = paper_resnet18.CONFIG
    data, source, loss_fn = _image_task(cfg, 100, 50, 10)
    params = _init(cfg)
    launches = {fn.__name__: 0 for fn in ops.KERNELS + sr_ops.KERNELS}
    staging = {}
    for label, name, exec_kw, exp, rounds, want, plan_kw in RUNS:
        plan = (None if plan_kw is None
                else FaultPlan.seeded(PLAN_SEED, **plan_kw))
        sampler = SAMPLERS.get(label, lambda: None)()
        trainer = _trainer(cfg, data, source, loss_fn, params, name, rounds,
                           "cuda", exec_kw,
                           ExponentialRuntime(mean=1.0) if exp else None,
                           plan, sampler)
        if trainer.layout.size != N_MAIN:
            raise AssertionError(f"ResNet18-GN has {trainer.layout.size} "
                                 f"parameters, expected {N_MAIN}")
        if label in PROFILED and trainer._codec_lossy:
            _annotate_codec(trainer)
        expect_q = None
        if plan is not None and trainer._engine is None:
            expect_q = _expected_sync_quarantine(rounds,
                                                 exec_kw["round_deadline"],
                                                 plan)
        elif plan is not None:
            expect_q = _record_fold_targets(trainer)
        torch.cuda.reset_peak_memory_stats()
        stochastic = exec_kw.get("codec") == "int8_sr"
        profile = None
        ops.reset_launches()               # this path starts here
        sr_ops.reset_launches()
        for t in range(rounds):
            before = [fn.launches for fn in ops.KERNELS]
            sr_before = sr_ops.int8_sr_quantize.launches
            wave = (trainer._engine.wave_frontier
                    if trainer._engine is not None else t)
            if label in PROFILED and t == rounds - 1:
                rec, profile = profile_round(trainer, t)
            else:
                rec = trainer.run_round(t)
            added = {fn.__name__: fn.launches - b
                     for fn, b in zip(ops.KERNELS, before)}
            expect = {k: int(k in want) for k in added}
            # int8_sr encodes once a round, or once a wave dispatched
            waves = (trainer._engine.wave_frontier - wave
                     if trainer._engine is not None else 1)
            sr_added = sr_ops.int8_sr_quantize.launches - sr_before
            if sr_added != (waves if stochastic else 0):
                raise AssertionError(f"{label} round {t}: int8_sr_quantize "
                                     f"launched {sr_added} times for "
                                     f"{waves} encodes")
            if added != expect:
                raise AssertionError(f"{label} round {t}: kernel launches "
                                     f"{added}, expected {expect}")
            if not math.isfinite(rec.train_loss):
                raise AssertionError(f"{label} round {t}: loss "
                                     f"{rec.train_loss}")
            if expect_q is not None and rec.quarantined != expect_q[t]:
                raise AssertionError(
                    f"{label} round {t}: quarantined {rec.quarantined}, "
                    f"the plan's targets among the arrivals {expect_q[t]}")
            emit({"phase": "trainer", "run": label, "model": cfg.name,
                  "algorithm": name, "round": t, "K": 10,
                  "N": trainer.layout.size, "M": trainer._max_batches,
                  "train_loss": rec.train_loss, "seconds": rec.seconds,
                  "staleness_mean": rec.staleness_mean,
                  "staleness_max": rec.staleness_max,
                  "comm_bytes_up": rec.comm_bytes_up,
                  "quarantined": rec.quarantined, "clipped": rec.clipped,
                  "deadline_dropped": rec.deadline_dropped,
                  "test_accuracy": rec.test_accuracy,
                  "diagnostics": rec.diagnostics})
        run_launches = {fn.__name__: fn.launches
                        for fn in ops.KERNELS + sr_ops.KERNELS}
        for k, v in run_launches.items():
            launches[k] += v
        trainer.close()               # the eval lands; the threads end
        hist = trainer.history
        if (trainer._engine is not None
                and not max(r.staleness_max for r in hist) > 0):
            raise AssertionError(f"{label}: no stale arrival in "
                                 f"{rounds} rounds")
        if not bool(torch.isfinite(trainer.flat).all()):
            raise AssertionError(f"{label}: non-finite parameters")
        if plan is not None and not (
                sum(r.quarantined for r in hist) > 0
                and sum(r.deadline_dropped for r in hist) > 0):
            raise AssertionError(f"{label}: the guard or the deadline "
                                 "never acted")
        table = trainer.server_state.get("y")
        if table is not None and (
                table.device != trainer.flat.device
                or tuple(table.shape) != (data.num_clients, N_MAIN)):
            raise AssertionError(f"{label}: FedVARP's table is "
                                 f"{tuple(table.shape)} on {table.device}")
        emit({"phase": "trainer", "run": label, "algorithm": name,
              "sampler": type(trainer.sampler).__name__,
              "server_opt": exec_kw.get("server_opt", "sgd"),
              "launches": run_launches,
              "median_seconds_after_0":
                  statistics.median(r.seconds for r in hist[1:]),
              "seconds_per_round_after_0": [r.seconds for r in hist[1:]],
              "diagnostics_keys": sorted(hist[-1].diagnostics),
              "table_bytes": (None if table is None
                              else table.numel() * table.element_size()),
              "staleness_mean": [r.staleness_mean for r in hist],
              "staleness_max": [r.staleness_max for r in hist],
              "comm_bytes_up": [r.comm_bytes_up for r in hist],
              "quarantined": [r.quarantined for r in hist],
              "clipped": [r.clipped for r in hist],
              "deadline_dropped": [r.deadline_dropped for r in hist],
              "test_accuracy": [r.test_accuracy for r in hist],
              "ingest_host_seconds": [r.ingest_host_seconds for r in hist],
              "ingest_device_seconds": [r.ingest_device_seconds
                                        for r in hist],
              "peak_memory_gib":
                  torch.cuda.max_memory_allocated() / 2 ** 30})
        if label in STAGING:
            staging[label] = {
                "regime": {k: getattr(trainer.cfg, k) for k in
                           ("prefetch", "prefetch_depth", "device_stage",
                            "async_eval")},
                "median_seconds_after_0":
                    statistics.median(r.seconds for r in hist[1:]),
                "ingest_host_seconds_median": statistics.median(
                    r.ingest_host_seconds for r in hist[1:]),
                "ingest_device_seconds_median": statistics.median(
                    r.ingest_device_seconds for r in hist[1:]),
                "profiled_idle_share": profile["device_idle_share"]}
        del trainer, table
        # the trainer sits in reference cycles (its stager holds a bound
        # method): free it, and FedVARP's table, before the next run's
        # peak memory is read
        gc.collect()
    emit({"phase": "staging", "model": cfg.name, "runs": staging})
    emit({"phase": "trainer", "launches": launches})
    return launches


def phase_parity():
    cfg = paper_lenet5.CONFIG
    data, source, loss_fn = _image_task(cfg, 10, 100, 20)
    params = _init(cfg)
    for label, name, exec_kw, exp, rounds, plan_kw in (
            # the prefetched, device-staged defaults
            ("feddpc", "feddpc", {}, False, 2, None),
            # the int8_sr kernel's codes against its plain version's
            ("feddpc_int8_sr", "feddpc", {"codec": "int8_sr"}, False, 3,
             None),
            ("feddpc_async_int8_ef", "feddpc", ASYNC_INT8_EF, True, 3,
             None),
            ("feddpc_chaos", "feddpc", CHAOS, True, 3, SYNC_PLAN),
            # the kernels' route (dots, batched epilogue) against the
            # plain one; FedVARP's table with the deadline's ID_SENTINEL
            # rows; FedCM's client extra
            ("feddpc_noscale", "feddpc_noscale", {}, False, 3, None),
            ("fedvarp_deadline", "fedvarp", {"round_deadline": 2.0}, True,
             3, None),
            ("fedcm", "fedcm", {}, False, 3, None)):
        runs = {}
        for device in ("cuda", "cpu"):
            trainer = _trainer(
                cfg, data, source, loss_fn, params, name, rounds,
                device, exec_kw,
                ExponentialRuntime(mean=1.0) if exp else None,
                None if plan_kw is None
                else FaultPlan.seeded(PLAN_SEED, **plan_kw))
            table = trainer.server_state.get("y")
            with trainer:
                runs[device] = (trainer.run(), trainer.flat.cpu(),
                                None if table is None else table.cpu())
        (h_gpu, w_gpu, y_gpu), (h_cpu, w_cpu, y_cpu) = (runs["cuda"],
                                                        runs["cpu"])
        diffs = [abs(a.train_loss - b.train_loss)
                 for a, b in zip(h_gpu, h_cpu)]
        emit({"phase": "parity", "run": label, "model": cfg.name,
              "loss_cuda": [r.train_loss for r in h_gpu],
              "loss_cpu": [r.train_loss for r in h_cpu],
              "staleness_max": [r.staleness_max for r in h_gpu],
              "quarantined": [r.quarantined for r in h_gpu],
              "deadline_dropped": [r.deadline_dropped for r in h_gpu],
              "max_loss_diff": max(diffs),
              "max_param_diff": float((w_gpu - w_cpu).abs().max()),
              "max_table_diff": (None if y_gpu is None
                                 else float((y_gpu - y_cpu).abs().max()))})
        for key in ("staleness_max", "quarantined", "clipped",
                    "deadline_dropped", "comm_bytes_up"):
            if [getattr(r, key) for r in h_gpu] != \
                    [getattr(r, key) for r in h_cpu]:
                raise AssertionError(f"{label}: card and CPU differ in "
                                     f"{key}")
        if not max(diffs) <= PARITY_ATOL:
            raise AssertionError(f"{label}: card vs CPU losses differ by "
                                 f"{max(diffs)} > {PARITY_ATOL}")
        if y_gpu is not None and not float(
                (y_gpu - y_cpu).abs().max()) <= TABLE_ATOL:
            raise AssertionError(f"{label}: card vs CPU FedVARP tables "
                                 f"differ by more than {TABLE_ATOL}")
        if "round_deadline" in exec_kw and not sum(
                r.deadline_dropped for r in h_gpu) > 0:
            raise AssertionError(f"{label}: the deadline dropped no client")
    _parity_checkpoint((cfg, data, source, loss_fn, params))
    _parity_cli()


# the reference CLI's losses and accuracies at the README's LeNet5
# arguments (python -m repro.launch.train, the same flags)
CLI_ARGS = ["--model", "lenet5", "--rounds", "2", "--clients", "6",
            "--participation", "0.5", "--samples-per-class", "20",
            "--batch-size", "16", "--eval-every", "1"]
CLI_REFERENCE = {"train_loss": [2.2307, 1.9362],
                 "test_accuracy": [0.390, 0.301]}


def _parity_cli():
    """The training CLI on the card and on the CPU: the CPU repeats the
    reference CLI's printed numbers, the card's losses are within
    PARITY_ATOL of the CPU's."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        for device in ("cuda", "cpu"):
            path = os.path.join(root, f"{device}.json")
            if train_cli.main(CLI_ARGS + ["--device", device, "--out",
                                          path]) != 0:
                raise AssertionError(f"train CLI on {device} failed")
            with open(path) as fh:
                out[device] = json.load(fh)
    got = {device: {k: [r[k] for r in hist] for k in CLI_REFERENCE}
           for device, hist in out.items()}
    diff = max(abs(a - b) for a, b in zip(got["cuda"]["train_loss"],
                                          got["cpu"]["train_loss"]))
    emit({"phase": "parity", "run": "train_cli", "args": CLI_ARGS,
          "reference_cli": CLI_REFERENCE, **{d: v for d, v in got.items()},
          "max_loss_diff": diff})
    cpu = {k: [round(v, 4 if k == "train_loss" else 3) for v in vals]
           for k, vals in got["cpu"].items()}
    if cpu != CLI_REFERENCE:
        raise AssertionError(f"train CLI on the CPU printed {cpu}, the "
                             f"reference CLI {CLI_REFERENCE}")
    if not diff <= PARITY_ATOL:
        raise AssertionError(f"train CLI card vs CPU losses differ by "
                             f"{diff} > {PARITY_ATOL}")


# ---- the ingest phase: a real-dataset reader, the producer's supervision

# the committed CIFAR-100 fixture (read only)
FIXTURE_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures", "data")
CRASH_PLAN = {"ingest_crash_rounds": (1,)}


def _ingest_cifar100(cfg):
    """ResNet18-GN on CIFAR100Source over the committed fixture, crop and
    flip on the staging thread: two sync FedDPC rounds of all 10 clients,
    one dots and one epilogue a round, accuracies on its test split."""
    source = CIFAR100Source(FIXTURE_ROOT, num_clients=10, alpha=0.5,
                            batch_size=8, augment=True, seed=0)
    te_x, te_y = (torch.from_numpy(a).cuda() for a in source.test_arrays())
    with FederatedTrainer(
            functools.partial(vision_loss_fn, cfg), _init(cfg), 10, source,
            ExecConfig(rounds=2, clients_per_round=10, seed=0,
                       eval_every=1),
            lambda p: vision_accuracy(cfg, p, te_x, te_y),
            algo=AlgoConfig(name="feddpc", eta_l=0.02, eta_g=0.02,
                            hyper=FedDPCHyper(lam=1.0)),
            device="cuda") as tr:
        ops.reset_launches()               # this path starts here
        hist = tr.run()
        launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
        m = tr._max_batches
    want = {k: 2 * int(k in SYNC_KERNELS) for k in launches}
    emit({"phase": "ingest", "case": "cifar100_fixture", "model": cfg.name,
          "train_images": int(sum(source.client_weights())), "M": m,
          "loss": [r.train_loss for r in hist],
          "test_accuracy": [r.test_accuracy for r in hist],
          "ingest_host_seconds": [r.ingest_host_seconds for r in hist],
          "launches": launches})
    if (launches != want or len(hist) != 2
            or not all(math.isfinite(r.train_loss) for r in hist)
            or any(r.test_accuracy is None for r in hist)):
        raise AssertionError(f"cifar100 fixture run: launches {launches}, "
                             f"history {hist}")


def phase_ingest():
    cfg = paper_resnet18.CONFIG
    tic = time.perf_counter()
    _ingest_cifar100(cfg)
    data, source, loss_fn = _image_task(cfg, 100, 50, 10)
    plan = FaultPlan.seeded(PLAN_SEED, **CRASH_PLAN)
    mk = functools.partial(_trainer, cfg, data, source, loss_fn, _init(cfg),
                           "feddpc", 3, "cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with mk() as tr:
            plain = tr.run()
            plain_flat = tr.flat.clone()
        ops.reset_launches()               # this path starts here
        with mk({"ingest_max_restarts": 1, "ingest_restart_backoff_s": 0.01},
                fault_plan=plan) as tr:
            hist = tr.run()
            dparams = float((tr.flat - plain_flat).abs().max())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    restarts = [r.ingest_restarts for r in hist]
    losses = [r.train_loss for r in hist]
    plain_losses = [r.train_loss for r in plain]
    emit({"phase": "ingest", "case": "ingest_crash_restart",
          "ingest_restarts": restarts, "loss": losses,
          "loss_uninterrupted": plain_losses,
          "max_abs_dparams": dparams, "launches": launches})
    # the restarted producer replays the uninterrupted run's draws, and on
    # cuDNN's deterministic algorithms a replayed run repeats bit for bit
    if (restarts != [0, 1, 0] or losses != plain_losses or dparams != 0.0
            or launches != {k: 3 * int(k in SYNC_KERNELS)
                            for k in launches}):
        raise AssertionError(f"ingest_crash run: restarts {restarts}, "
                             f"losses {losses} against {plain_losses}, "
                             f"max |dparams| {dparams}, launches {launches}")
    raised = None
    with mk({"ingest_restart_backoff_s": 0.01}, fault_plan=plan) as tr:
        try:
            tr.run()
        except RuntimeError as e:
            raised = str(e)
        rounds_run = len(tr.history)
    emit({"phase": "ingest", "case": "ingest_crash_no_budget",
          "rounds_run": rounds_run,
          "raised": None if raised is None else raised.splitlines()[0],
          "names_the_crash": raised is not None
          and "injected ingest producer crash at round 1" in raised})
    if (raised is None or rounds_run != 1
            or "injected ingest producer crash at round 1" not in raised):
        raise AssertionError("ingest_max_restarts=0 did not raise on the "
                             f"injected crash (rounds run {rounds_run})")
    emit({"phase": "ingest", "seconds": time.perf_counter() - tic})


# ---- the checkpoint phase: save, resume, the fallback, the health stop.
# Full width (ResNet18-GN, 10 of 30 clients), checkpoints in a temporary
# directory; every resumed round must launch its regime's kernels.

CKPT_LOSS_RTOL = 1e-5      # resumed vs uninterrupted round losses
NO_EVAL = {"eval_every": 10 ** 9}       # evaluate in the last round only
CORRUPT_MODES = ("truncate", "bitflip", "drop_digest")


def _rss_gib() -> dict:
    """The process's peak resident set (getrusage) and current one."""
    peak_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    with open("/proc/self/statm") as fh:
        pages = int(fh.read().split()[1])
    return {"peak_rss_gib": peak_kib / 2 ** 20,
            "rss_gib": pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 30}


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _snapshot(trainer) -> dict:
    """Copies of everything a checkpoint must bring back bit for bit."""
    snap = {"flat": trainer.flat.clone()}
    for k, v in trainer.server_state.items():
        snap[f"state/{k}"] = v.clone()
    for k, v in (trainer._opt_state or {}).items():
        snap[f"opt/{k}"] = v.clone()
    if trainer._ef is not None:
        snap["ef"] = trainer._ef.clone()
    return snap


def _check_restored(label, snap, trainer):
    got = _snapshot(trainer)
    if set(got) != set(snap):
        raise AssertionError(f"{label}: restored {sorted(got)}, saved "
                             f"{sorted(snap)}")
    for k, v in snap.items():
        if got[k].device != trainer.flat.device or not torch.equal(got[k], v):
            raise AssertionError(f"{label}: {k} not restored bit for bit")


def _timed(fn):
    torch.cuda.synchronize()
    tic = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - tic


def _resumed_rounds(label, trainer, rounds, want):
    """Run the resumed rounds; each must launch each kernel of ``want``
    once (and no other) and have a finite loss."""
    out = []
    for t in rounds:
        before = [fn.launches for fn in ops.KERNELS]
        rec = trainer.run_round(t)
        added = {fn.__name__: fn.launches - b
                 for fn, b in zip(ops.KERNELS, before)}
        expect = {k: int(k in want) for k in added}
        if added != expect:
            raise AssertionError(f"{label} resumed round {t}: launches "
                                 f"{added}, expected {expect}")
        if not math.isfinite(rec.train_loss):
            raise AssertionError(f"{label} resumed round {t}: loss "
                                 f"{rec.train_loss}")
        out.append(rec)
    return out


def _check_losses(label, recs, reference):
    """Each resumed round's loss within CKPT_LOSS_RTOL of the
    uninterrupted run's same round."""
    for rec in recs:
        want = reference[rec.round].train_loss
        if not abs(rec.train_loss - want) <= CKPT_LOSS_RTOL * abs(want):
            raise AssertionError(f"{label} resumed round {rec.round}: loss "
                                 f"{rec.train_loss}, uninterrupted {want}")


def _ckpt_sync(task, root):
    """(a) Sync FedDPC: 4 rounds uninterrupted twice; 2 rounds, save,
    resume in a fresh trainer, rounds 2-3. The resumed trainer saves
    after round 2, for (d)."""
    mk = functools.partial(_trainer, *task, "feddpc", 4, "cuda", NO_EVAL)
    want = ("feddpc_dots", "feddpc_batched_epilogue")
    fulls = []
    for _ in range(2):
        with mk() as tr:
            tr.run()
        fulls.append((tr.history, tr.flat.clone()))
        del tr
    d = os.path.join(root, "sync")
    part = mk()
    for t in range(2):
        part.run_round(t)
    snap = _snapshot(part)
    _, save_s = _timed(lambda: part.save(d))
    part.close()
    del part
    res = mk()
    _, restore_s = _timed(lambda: res.restore(d))
    _check_restored("sync feddpc", snap, res)
    if res.start_round != 2:
        raise AssertionError(f"sync feddpc resumed at {res.start_round}")
    recs = _resumed_rounds("sync feddpc", res, [2], want)
    res.save(d)                                   # step 3, for (d)
    recs += _resumed_rounds("sync feddpc", res, [3], want)
    res.close()
    (h0, w0), (h1, w1) = fulls
    repeat = float((w0 - w1).abs().max())
    resumed = float((res.flat - w0).abs().max())
    emit({"phase": "checkpoint", "case": "sync_feddpc",
          "N": res.layout.size, "save_s": save_s, "restore_s": restore_s,
          "bytes_on_disk": _dir_bytes(os.path.join(d, "step_00000002")),
          "loss_uninterrupted": [r.train_loss for r in h0],
          "loss_repeat": [r.train_loss for r in h1],
          "loss_resumed": [r.train_loss for r in recs],
          "max_abs_dparams_repeat": repeat,
          "max_abs_dparams_resumed": resumed,
          "bitwise_repeat": repeat == 0.0,
          "bitwise_resumed": resumed == 0.0})
    _check_losses("sync feddpc", recs, h0)
    if repeat == 0.0 and resumed != 0.0:
        raise AssertionError(f"sync feddpc: two uninterrupted runs agree "
                             f"bit for bit, the resumed one is "
                             f"{resumed} away")
    return d, snap["flat"], h0


def _ckpt_fedvarp(task, root):
    """(b) FedVARP under Markov availability and a FedAdam server step:
    the (30, N) table, the moments and the chain restored bit for bit;
    save and restore seconds, bytes on disk, the host's peak RSS."""
    def mk():
        return _trainer(*task, "fedvarp", 3, "cuda",
                        {**NO_EVAL, "server_opt": "fedadam"},
                        sampler=MarkovSampler(30, 10, p_on=0.5, p_off=0.5))
    d = os.path.join(root, "fedvarp")
    part = mk()
    for t in range(2):
        part.run_round(t)
    snap = _snapshot(part)
    # the chain as of the saved frontier (the staging ring has sampled
    # rounds past it)
    chain = part.state().sampler_state
    rss = {"before_save": _rss_gib()}
    _, save_s = _timed(lambda: part.save(d))
    rss["after_save"] = _rss_gib()
    part.close()
    del part
    gc.collect()
    torch.cuda.empty_cache()
    res = mk()
    _, restore_s = _timed(lambda: res.restore(d))
    rss["after_restore"] = _rss_gib()
    _check_restored("fedvarp", snap, res)
    if res.sampler.state_dict() != chain:
        raise AssertionError("fedvarp: the Markov chain was not restored")
    recs = _resumed_rounds("fedvarp", res, [2], ())
    res.close()
    table = res.server_state["y"]
    emit({"phase": "checkpoint", "case": "fedvarp_markov_fedadam",
          "table_bytes": table.numel() * table.element_size(),
          "save_s": save_s, "restore_s": restore_s,
          "bytes_on_disk": _dir_bytes(os.path.join(d, "step_00000002")),
          "rss": rss, "loss_resumed": [r.train_loss for r in recs]})
    del res, table, snap
    gc.collect()


def _ckpt_async(task, root, label, exec_kw, rounds, cut, want, plan_kw):
    """(c) An async int8+EF run saved mid-buffer (entries in flight) and
    resumed: EF, the guard's window and the in-flight entries back bit
    for bit; the resumed rounds launch the regime's kernels, and a chaos
    run quarantines exactly the plan's targets among the arrivals."""
    plan = (None if plan_kw is None
            else FaultPlan.seeded(PLAN_SEED, **plan_kw))
    mk = functools.partial(_trainer, *task, "feddpc", rounds, "cuda",
                           {**NO_EVAL, **exec_kw}, fault_plan=plan)
    with mk(runtime=ExponentialRuntime(mean=1.0)) as full:
        full.run()
    d = os.path.join(root, label)
    part = mk(runtime=ExponentialRuntime(mean=1.0))
    for t in range(cut):
        part.run_round(t)
    entries = part._engine.inflight()
    if not entries:
        raise AssertionError(f"{label}: no entry in flight at the save")
    snap = _snapshot(part)
    guard = None if part._guard is None else part._guard.state_dict()
    clock = (part._engine.clock, part._engine.seq,
             part._engine.wave_frontier)
    _, save_s = _timed(lambda: part.save(d))
    part.close()
    del part
    res = mk(runtime=ExponentialRuntime(mean=1.0))
    _, restore_s = _timed(lambda: res.restore(d))
    _check_restored(label, snap, res)
    eng = res._engine
    got = eng.inflight()
    if ((eng.clock, eng.seq, eng.wave_frontier) != clock
            or [(e.client, e.seq, e.finish) for e in got]
            != [(e.client, e.seq, e.finish) for e in entries]
            or not all(torch.equal(a.delta["q"], b.delta["q"])
                       for a, b in zip(got, entries))):
        raise AssertionError(f"{label}: the async state was not restored")
    if guard is not None and res._guard.state_dict() != guard:
        raise AssertionError(f"{label}: the guard window was not restored")
    targets = _record_fold_targets(res) if plan is not None else None
    recs = _resumed_rounds(label, res, range(cut, rounds), want)
    res.close()
    if targets is not None:
        got_q = [r.quarantined for r in recs]
        if got_q != targets or not sum(got_q):
            raise AssertionError(f"{label}: quarantined {got_q}, the "
                                 f"plan's targets {targets}")
    emit({"phase": "checkpoint", "case": label, "inflight": len(entries),
          "save_s": save_s, "restore_s": restore_s,
          "bytes_on_disk": _dir_bytes(os.path.join(d, f"step_{cut:08d}")),
          "loss_uninterrupted": [r.train_loss for r in full.history],
          "loss_resumed": [r.train_loss for r in recs],
          "quarantined_resumed": [r.quarantined for r in recs],
          "max_abs_dparams_resumed":
              float((res.flat - full.flat).abs().max())})
    _check_losses(label, recs, full.history)


def _ckpt_corrupt(task, root, sync_dir, snap_flat, reference):
    """(d) The newest step (3) corrupted in each mode: resume falls back
    to step 2 with a RuntimeWarning and continues."""
    mk = functools.partial(_trainer, *task, "feddpc", 4, "cuda", NO_EVAL)
    for mode in CORRUPT_MODES:
        d = os.path.join(root, f"corrupt_{mode}")
        shutil.copytree(sync_dir, d)
        corrupt_checkpoint(d, 3, mode)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = mk(resume_from=d)
        skipped = [str(w.message) for w in caught
                   if issubclass(w.category, RuntimeWarning)
                   and "skipping corrupt checkpoint step 3" in
                   str(w.message)]
        if (not skipped or res.start_round != 2
                or not torch.equal(res.flat, snap_flat)):
            raise AssertionError(f"corrupt {mode}: resumed at "
                                 f"{res.start_round}, warnings {skipped}")
        recs = _resumed_rounds(f"corrupt {mode}", res, [2],
                               ("feddpc_dots", "feddpc_batched_epilogue"))
        res.close()
        emit({"phase": "checkpoint", "case": f"corrupt_{mode}",
              "fell_back_to": res.start_round, "warning": skipped[0][:120],
              "loss_resumed": recs[0].train_loss})
        _check_losses(f"corrupt {mode}", recs, reference)
        del res


def _ckpt_health(task, root):
    """(e) Sync FedDPC with the health monitor (patience 1) and NaN
    deltas in round 1, unguarded (a guarded NaN row is quarantined and
    never reaches the loss): run() stops on the reference's alarm, and
    the health log holds one JSON row per round run."""
    log = os.path.join(root, "health.jsonl")
    tr = _trainer(*task, "feddpc", 4, "cuda",
                  {**NO_EVAL, "health": True, "health_patience": 1,
                   "health_log": log},
                  fault_plan=FaultPlan.seeded(PLAN_SEED, nan_rate=1.0,
                                              nan_rounds=(1,)))
    with tr:
        hist = tr.run()
    rep = tr.health_report
    with open(log) as fh:
        rows = [json.loads(line) for line in fh]
    if (rep is None or not rep.should_stop or "nonfinite_loss"
            not in rep.alarms or len(hist) >= 4
            or [r["step"] for r in rows] != [r.round for r in hist]):
        raise AssertionError(f"health: {len(hist)} rounds, report {rep}, "
                             f"log steps {[r['step'] for r in rows]}")
    emit({"phase": "checkpoint", "case": "health_stop",
          "rounds_run": len(hist), "alarms": rep.alarms,
          "loss": [r.train_loss for r in hist],
          "log_rows": len(rows)})


def phase_checkpoint():
    cfg = paper_resnet18.CONFIG
    data, source, loss_fn = _image_task(cfg, 100, 50, 10)
    task = (cfg, data, source, loss_fn,
            _init(cfg))
    tic = time.perf_counter()
    ops.reset_launches()               # this phase's paths start here
    # cuDNN's default convolution algorithms do not promise to repeat bit
    # for bit, and on an H100 three identical ResNet18-GN runs reach round
    # 2 with losses 3e-5 apart (relative). This phase holds resumed runs
    # against uninterrupted ones, so it takes cuDNN's deterministic
    # algorithms and gives the default back after; the timed runs of the
    # trainer phase keep the default.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
            sync_dir, snap_flat, reference = _ckpt_sync(task, root)
            _ckpt_fedvarp(task, root)
            _ckpt_async(task, root, "async_int8_ef", ASYNC_INT8_EF, 4, 2,
                        ("feddpc_dots", "feddpc_dequant_buffer_fold"), None)
            _ckpt_async(task, root, "async_int8_chaos",
                        {**ASYNC_INT8_EF, **CHAOS}, 6, 3,
                        ("feddpc_guard_dots", "feddpc_dots",
                         "feddpc_buffer_fold"), ASYNC_PLAN)
            _ckpt_corrupt(task, root, sync_dir, snap_flat, reference)
            _ckpt_health(task, root)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit({"phase": "checkpoint",
          "launches": {fn.__name__: fn.launches for fn in ops.KERNELS},
          "seconds": time.perf_counter() - tic})


MR_CLIENTS = 100
MR_COHORT = 10     # a round's clients (see mr_cohort)
MR_ROUNDS = 4
MR_CUT = 2
MR_RTOL = 1e-4     # losses and params: ranks against one process
MR_EDGE_PLAN = {"edge_drop_rounds": (2,), "edge_drop_edges": (1,)}
# run -> (ExecConfig overrides, edge-drop plan?)
MR_RUNS = {"a": ({"shard_clients": True}, False),
           "b": ({"shard_clients": True, "edges": 2}, False),
           "c": ({"shard_clients": True, "edges": 2}, True)}
MR_WORKER = "--multirank-worker"


def _mr_task():
    cfg = paper_resnet18.CONFIG
    data = build_federated_image_data(
        num_classes=100, num_clients=MR_CLIENTS, alpha=0.2,
        samples_per_class=50, test_per_class=10, seed=0)
    return (cfg, data, StreamingImageSource(data, batch_size=64),
            functools.partial(vision_loss_fn, cfg), _init(cfg))


def mr_cohort(ranks: int) -> int:
    """MR_COHORT, rounded up to a multiple of the ranks: the edges split
    the cohort padded to the ranks, so with padding an edge's rows (and
    the clients an edge drop loses) would differ from one process's."""
    return -(-MR_COHORT // ranks) * ranks


def _mr_trainer(task, run, k, resume_from=None):
    exec_kw, drop = MR_RUNS[run]
    return _trainer(*task, "feddpc", MR_ROUNDS, "cuda",
                    {**NO_EVAL, "clients_per_round": k, **exec_kw},
                    sampler=UniformSampler(MR_CLIENTS, k),
                    fault_plan=(FaultPlan.seeded(PLAN_SEED, **MR_EDGE_PLAN)
                                if drop else None),
                    resume_from=resume_from)


def _multirank_worker(out: str) -> int:
    """One rank of the multirank phase: runs (a)-(c) and (b) cut at round
    2 (rank 0 writes the checkpoint), and writes what each left under
    ``out``: its JSON line per run and rank 0's final params."""
    ctx = distributed.maybe_initialize()
    torch.backends.cudnn.deterministic = True
    task = _mr_task()
    k = mr_cohort(ctx.num_processes)
    lines = []
    for run in MR_RUNS:
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with _mr_trainer(task, run, k) as tr:
            tr.run()
        launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
        peak = torch.cuda.max_memory_allocated()
        if ctx.process_id == 0:
            torch.save(tr.flat.cpu(), os.path.join(out, f"{run}.pt"))
        lo, hi = tr._rows
        coll = collections.defaultdict(list)
        for rnd in tr.collective_log:
            for name, ms in rnd:
                coll[name].append(ms)
        lines.append({
            "phase": "multirank", "run": run, "rank": ctx.process_id,
            "backend": ctx.backend, "ranks": ctx.num_processes,
            "cards": torch.cuda.device_count(),
            "device": str(tr.device), "rows": [lo, hi],
            "pieces": len(edge_pieces(lo, hi, tr._pad_to,
                                      MR_RUNS[run][0].get("edges"))),
            "launches": launches,
            "collective_ms": dict(coll),
            "round_seconds": [r.seconds for r in tr.history],
            "peak_gib": peak / 2 ** 30,
            "losses": [r.train_loss for r in tr.history],
            "edge_dropped": [r.edge_dropped for r in tr.history],
            "comm_bytes_server_up": [r.comm_bytes_server_up
                                     for r in tr.history],
            "comm_bytes_edge_up": [r.comm_bytes_edge_up
                                   for r in tr.history]})
    with _mr_trainer(task, "b", k) as tr:
        for t in range(MR_CUT):
            tr.run_round(t)
        tr.save(os.path.join(out, "ckpt"))
    with open(os.path.join(out, f"rank{ctx.process_id}.json"), "w") as fh:
        json.dump(lines, fh)
    return 0


def _mr_check_params(label, got, want):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= MR_RTOL * scale:
        raise AssertionError(f"multirank {label}: params {err} from the "
                             f"single-process run's (max |w| {scale})")
    return err / scale


def _mr_check_losses(label, got, want):
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    if len(got) != len(want) or not max(rel) <= MR_RTOL:
        raise AssertionError(f"multirank {label}: losses {got}, single "
                             f"process {want}")
    return max(rel)


def phase_multirank():
    cards = torch.cuda.device_count()
    ranks, backend = (min(4, cards), "nccl") if cards >= 2 else (2, "gloo")
    k = mr_cohort(ranks)
    tic = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        task = _mr_task()
        single = {}
        for run in MR_RUNS:
            with _mr_trainer(task, run, k) as tr:
                tr.run()
            single[run] = (tr.history, tr.flat.clone())
            del tr
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mr_") as out:
            env = {}
            if backend == "nccl":
                env["NCCL_SOCKET_IFNAME"] = os.environ.get(
                    "NCCL_SOCKET_IFNAME", "lo")
            job_tic = time.perf_counter()
            distributed.spawn_local(
                [sys.executable, os.path.abspath(__file__), MR_WORKER, out],
                ranks, backend=backend,
                local_devices=1 if backend == "gloo" else None, env=env,
                timeout_s=480)
            job_s = time.perf_counter() - job_tic
            lines = []
            for r in range(ranks):
                with open(os.path.join(out, f"rank{r}.json")) as fh:
                    lines += json.load(fh)
            params = {run: torch.load(os.path.join(out, f"{run}.pt"))
                      for run in MR_RUNS}
            with _mr_trainer(task, "b", k,
                             resume_from=os.path.join(out, "ckpt")) as res:
                if res.start_round != MR_CUT:
                    raise AssertionError(f"multirank d: resumed at "
                                         f"{res.start_round}")
                res.run()
            resumed = (res.history, res.flat.cpu())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for line in lines:
        run = line["run"]
        per_round = {"feddpc_dots": 1,
                     "feddpc_batched_epilogue": line["pieces"]}
        line["expected_launches"] = {k: MR_ROUNDS * v
                                     for k, v in per_round.items()}
        emit(line)
        got = {k: line["launches"][k] for k in per_round}
        if got != line["expected_launches"]:
            raise AssertionError(f"multirank {run} rank {line['rank']}: "
                                 f"launches {got}, expected "
                                 f"{line['expected_launches']}")
        if line["losses"] != [x["losses"] for x in lines
                              if x["run"] == run][0]:
            raise AssertionError(f"multirank {run}: the ranks' losses "
                                 "differ")
    summary = {"phase": "multirank", "backend": backend, "ranks": ranks,
               "cards": cards, "clients_per_round": k, "job_seconds": job_s}
    for run in MR_RUNS:
        hist, flat = single[run]
        line = next(x for x in lines if x["run"] == run)
        summary[run] = {
            "loss_single": [r.train_loss for r in hist],
            "loss_ranks": line["losses"],
            "loss_max_rel": _mr_check_losses(run, line["losses"],
                                             [r.train_loss for r in hist]),
            "params_max_rel": _mr_check_params(run, params[run],
                                               flat.cpu()),
            "single_round_seconds": [r.seconds for r in hist]}
        if line["edge_dropped"] != [r.edge_dropped for r in hist]:
            raise AssertionError(f"multirank {run}: edge_dropped "
                                 f"{line['edge_dropped']}")
    c = next(x for x in lines if x["run"] == "c")
    if (c["edge_dropped"] != [0, 0, 1, 0]
            or 2 * c["comm_bytes_server_up"][2] != c["comm_bytes_server_up"][0]
            or c["comm_bytes_edge_up"][2] != c["comm_bytes_edge_up"][0]
            or c["losses"][:2] != next(x for x in lines
                                       if x["run"] == "b")["losses"][:2]):
        raise AssertionError(f"multirank c: the dropped edge's rows were "
                             f"not masked as planned: {c}")
    summary["d"] = {
        "loss_resumed": [r.train_loss for r in resumed[0][MR_CUT:]],
        "loss_max_rel": _mr_check_losses(
            "d", [r.train_loss for r in resumed[0][MR_CUT:]],
            [r.train_loss for r in single["b"][0][MR_CUT:]]),
        "params_max_rel_vs_single": _mr_check_params(
            "d", resumed[1], single["b"][1].cpu()),
        "params_max_rel_vs_ranks": _mr_check_params(
            "d", resumed[1], params["b"])}
    summary["seconds"] = time.perf_counter() - tic
    emit(summary)


MA_ROUNDS = 4
MA_CUT = 2
MA_LM_ROUNDS = 2
MA_CODEC_RTOL = 1e-3   # codec runs: int8 codes may flip on rounding
MA_WORKER = "--model-axis-worker"
# run -> (ExecConfig overrides besides the mesh's, rounds)
MA_RUNS = {"a": ({}, MA_ROUNDS),                           # sharded2d
           "b": ({"codec": "int8"}, MA_ROUNDS),            # codec_int8_2d
           "c": ({"server_opt": "fedadam"}, MA_ROUNDS),    # fedadam_2d
           "d": ({"codec": "int8_sr"}, MA_ROUNDS)}
MA_COLLECTIVES = ("param_all_gather", "all_to_all", "model_sum",
                  "all_gather", "all_reduce")


MA_MODEL = 2          # model shards of the ResNet18-GN runs


def ma_layout(cards: int):
    """(ranks, backend) of the model_axis job: 4 NCCL ranks as (2 clients
    x 2 model) on four cards or more, (1 x 2) on two or three, 2 gloo
    ranks on one card."""
    if cards >= 4:
        return 4, "nccl"
    return 2, ("nccl" if cards >= 2 else "gloo")


def _ma_expected(run, rounds):
    """Launches a rank's run implies: one reduction pass and one fold
    over its client slice's rows (no edges: one piece) a round; with a
    codec the dequant fold, int8_sr's encode once."""
    codec = MA_RUNS.get(run, ({}, 0))[0].get("codec")
    per = {"feddpc_dots": 1,
           "feddpc_dequant_batched_epilogue" if codec
           else "feddpc_batched_epilogue": 1}
    if codec == "int8_sr":
        per["int8_sr_quantize"] = 1
    return {k: rounds * v for k, v in per.items()}


def _ma_launches():
    out = {fn.__name__: fn.launches for fn in ops.KERNELS}
    out["int8_sr_quantize"] = sr_ops.int8_sr_quantize.launches
    return {k: v for k, v in out.items() if v}


def _ma_reset():
    ops.reset_launches()
    sr_ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()


def _ma_line(run, tr, ctx, rounds):
    """One rank's line of a run: its place, what it holds at rest, its
    peak memory, launches, collectives and round seconds."""
    info = tr.shard_info()
    n, n_m = info["N"], info["N_m"]
    lo, hi = info["slice_rows"]
    a, b = info["train_rows"]
    coll = collections.defaultdict(lambda: [0.0] * len(tr.collective_log))
    for i, rnd in enumerate(tr.collective_log):
        for name, ms in rnd:
            coll[name][i] += ms
    model = info["mesh"][1]
    # the row split trains its rows at full width, then holds the
    # slice's shards; the tensor-parallel route trains the shards
    stack = (hi - lo) * n_m if info["route"] == "tensor_parallel" else \
        (b - a) * n + (hi - lo) * n_m
    return {
        "phase": "model_axis", "run": run, "rank": ctx.process_id,
        "backend": ctx.backend, "mesh": info["mesh"],
        "route": info["route"], "coords": info["coords"], "N": n,
        "N_m": n_m, "N_over_M": n / model, "slice_rows": [lo, hi],
        "train_rows": [a, b], "bytes_at_rest": {
            **info["bytes"], "delta_stack": 4 * stack},
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": _ma_launches(),
        "expected_launches": _ma_expected(run, rounds),
        "collective_ms_per_round": dict(coll),
        "round_seconds": [r.seconds for r in tr.history],
        "losses": [r.train_loss for r in tr.history]}


def _ma_lm_trainer(rounds, exec_kw):
    task = llm_example.build(tiny=False, rounds=rounds, device="cuda")
    return FederatedTrainer(
        task.loss_fn, task.params, task.clients, task.batch_fn,
        ExecConfig(rounds=rounds, clients_per_round=task.cohort,
                   eval_every=10 ** 9, **exec_kw), None,
        algo=AlgoConfig(name="feddpc", eta_l=task.eta, eta_g=task.eta,
                        hyper=FedDPCHyper(lam=1.0)), device="cuda")


def _model_axis_worker(out: str) -> int:
    """One rank of the model_axis phase: runs (a)-(d) on the mesh, (a)
    cut at round 2 (rank 0 writes the checkpoint) and (f), the ~101M LM
    on a (1 x ranks) mesh; writes its lines and rank 0's gathered
    params."""
    ctx = distributed.maybe_initialize()
    torch.backends.cudnn.deterministic = True
    ranks, model = ctx.num_processes, MA_MODEL
    task = _mr_task()
    lines = [_ma_codec_check(ctx, task[-1], model)]
    for run, (kw, rounds) in MA_RUNS.items():
        _ma_reset()
        with _ma_trainer(task, kw, model) as tr:
            tr.run()
            full = tr.full_params()
        lines.append(_ma_line(run, tr, ctx, rounds))
        if ctx.process_id == 0:
            torch.save(full.cpu(), os.path.join(out, f"{run}.pt"))
        del tr, full
    _ma_reset()
    with _ma_trainer(task, MA_RUNS["a"][0], model) as tr:
        for t in range(MA_CUT):
            tr.run_round(t)
        tr.save(os.path.join(out, "ckpt"))
    lines.append(_ma_line("e", tr, ctx, MA_CUT))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    _ma_reset()
    with _ma_lm_trainer(MA_LM_ROUNDS, {"shard_clients": True,
                                       "shard_model": ranks}) as tr:
        tr.run()
        full = tr.full_params()
    lines.append(_ma_line("f", tr, ctx, MA_LM_ROUNDS))
    if ctx.process_id == 0:
        torch.save(full.cpu(), os.path.join(out, "f.pt"))
    with open(os.path.join(out, f"rank{ctx.process_id}.json"), "w") as fh:
        json.dump(lines, fh)
    return 0


def _ma_codec_check(ctx, params, model):
    """Each rank's uplink encode of its block of one round's deltas —
    the client slice's rows, its model shard's columns, through the
    codec with the rank's RankShard — bitwise the one-process encode of
    the whole (K, N) stack restricted to the block: int8's codes, scales
    and zeros (whole-leaf extrema over the model group) and int8_sr's
    codes (the whole stack's noise). Controls, read on the same block:
    int8 with the shard's own extrema, int8_sr drawn as if the block
    were the whole stack (no row0, rows_total or leaf blocks); the
    parent requires them to differ somewhere."""
    from repro_torch.core.round import RankShard
    from repro_torch.launch.mesh import make_cohort_mesh
    from repro_torch.sharding.layout import ShardLayout
    from repro_torch.sharding.rules import padded_rows
    mesh = make_cohort_mesh(model=model)
    layout = layout_of(params)
    shards = ShardLayout.from_mesh(layout, mesh)
    clients = ctx.num_processes // model
    rows = padded_rows(MR_COHORT, clients)
    rs = RankShard(mesh["clients"].get_group(), rows,
                   model_group=mesh["model"].get_group(), shards=shards)
    m, lo, hi = rs.mrank, rs.lo, rs.hi
    gen = torch.Generator(device="cuda").manual_seed(21)
    whole = torch.randn((rows, layout.size), generator=gen,
                        device="cuda") * 0.01
    block = shards.scatter(whole[lo:hi], m)
    offs, ids = shards.offsets(m), torch.from_numpy(shards.leaf_ids(m))
    key = jax_prng.fold_in(jax_prng.PRNGKey(0), 3)
    out = {"phase": "model_axis", "run": "codec_check",
           "rank": ctx.process_id, "coords": [rs.rank, m],
           "rows": [lo, hi], "rows_total": rows, "N_m": shards.sizes[m]}
    for name in ("int8", "int8_sr"):
        codec = make_codec(name)
        kw = {"key": key} if codec.stochastic else {}
        want = codec.encode_cohort(whole, layout.leaf_offsets, **kw)
        got = codec.encode_cohort(block, offs, shard=rs, **kw)
        if name == "int8":
            control = codec.encode_cohort(block, offs)["q"]
        else:
            control = sr_ops.int8_sr_quantize(
                block, got["scale"], offs,
                jax_prng.fold_in_many(key, shards.leaf_ids(m)))
        want_q = shards.scatter(want["q"][lo:hi], m)
        diff = {"q": int((got["q"] != want_q).sum())}
        for f in ("scale", "zero"):
            w = want[f][lo:hi][:, ids.to(whole.device)]
            diff[f] = int((got[f] != w).sum())
        out[name] = {"mismatches": diff, "bitwise_equal":
                     not any(diff.values()),
                     "control_mismatches": int((control != want_q).sum()),
                     "codes": int(want_q.numel())}
        del want, got, control, want_q
    del whole, block
    torch.cuda.empty_cache()
    return out


def _ma_trainer(task, kw, model, resume_from=None):
    mesh = {} if model is None else {"shard_clients": True,
                                     "shard_model": model}
    return _trainer(*task, "feddpc", MA_ROUNDS, "cuda",
                    {**NO_EVAL, "clients_per_round": MR_COHORT, **kw,
                     **mesh},
                    sampler=UniformSampler(MR_CLIENTS, MR_COHORT),
                    resume_from=resume_from)


def _ma_check(label, got_losses, want_losses, got, want, rtol):
    rel = max(abs(a - b) / abs(b) for a, b in zip(got_losses, want_losses))
    err = float((got - want).abs().max()) / float(want.abs().max())
    if len(got_losses) != len(want_losses) or not (rel <= rtol
                                                   and err <= rtol):
        raise AssertionError(
            f"model_axis {label}: losses {got_losses} against one "
            f"process's {want_losses}; params {err} of max |w| (gate "
            f"{rtol})")
    return {"loss_max_rel": rel, "params_max_rel": err}


def phase_model_axis():
    """The model axis at full width: ResNet18-GN FedDPC (multirank's
    task, K = 10 of 100, 4 rounds, deterministic cuDNN) on a (clients,
    model) mesh of ranks (ma_layout) in four runs — (a) sharded2d, (b)
    codec_int8_2d, (c) server_fedadam_2d, (d) int8_sr — (e) (a) cut at
    round 2 and resumed in this process, and (f) the ~101M federated LM
    (the example's configuration, 2 rounds) on a (1 x ranks) mesh, so
    the Megatron name rules shard a real LM tree, trained
    tensor-parallel (its route checked on every rank, with no
    param_all_gather or all_to_all in its collectives). Each run is held
    against this process's one-process run of the same ExecConfig
    (losses and params within MR_RTOL, the codec runs within
    MA_CODEC_RTOL), each rank's launches against its rows and its peak
    memory beside one process's; before the runs, each rank's int8 and
    int8_sr encode of its block bitwise the one-process encode
    (_ma_codec_check)."""
    cards = torch.cuda.device_count()
    (ranks, backend), model = ma_layout(cards), MA_MODEL
    tic = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    single = {}
    try:
        task = _mr_task()
        for run, (kw, _) in MA_RUNS.items():
            torch.cuda.reset_peak_memory_stats()
            with _ma_trainer(task, kw, None) as tr:
                tr.run()
            single[run] = ([r.train_loss for r in tr.history],
                           tr.flat.cpu(), [r.seconds for r in tr.history],
                           torch.cuda.max_memory_allocated() / 2 ** 30)
            del tr
        torch.cuda.reset_peak_memory_stats()
        with _ma_lm_trainer(MA_LM_ROUNDS, {}) as tr:
            tr.run()
        single["f"] = ([r.train_loss for r in tr.history], tr.flat.cpu(),
                       [r.seconds for r in tr.history],
                       torch.cuda.max_memory_allocated() / 2 ** 30)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ma_") as out:
            env = {}
            if backend == "nccl":
                env["NCCL_SOCKET_IFNAME"] = os.environ.get(
                    "NCCL_SOCKET_IFNAME", "lo")
            job_tic = time.perf_counter()
            distributed.spawn_local(
                [sys.executable, os.path.abspath(__file__), MA_WORKER, out],
                ranks, backend=backend,
                local_devices=1 if backend == "gloo" else None, env=env,
                timeout_s=600)
            job_s = time.perf_counter() - job_tic
            lines = []
            for r in range(ranks):
                with open(os.path.join(out, f"rank{r}.json")) as fh:
                    lines += json.load(fh)
            for line in lines:
                emit(line)
            params = {run: torch.load(os.path.join(out, f"{run}.pt"))
                      for run in (*MA_RUNS, "f")}
            with _ma_trainer(task, MA_RUNS["a"][0], None,
                             resume_from=os.path.join(out, "ckpt")) as res:
                if res.start_round != MA_CUT:
                    raise AssertionError(f"model_axis e: resumed at "
                                         f"{res.start_round}")
                res.run()
            resumed = ([r.train_loss for r in res.history[MA_CUT:]],
                       res.flat.cpu())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    checks = [x for x in lines if x["run"] == "codec_check"]
    lines = [x for x in lines if x["run"] != "codec_check"]
    for name in ("int8", "int8_sr"):
        if not all(x[name]["bitwise_equal"] for x in checks):
            raise AssertionError(
                f"model_axis codec_check {name}: a rank's encode of its "
                "block differs from the one-process encode: "
                f"{[x[name]['mismatches'] for x in checks]}")
        if not sum(x[name]["control_mismatches"] for x in checks):
            raise AssertionError(f"model_axis codec_check {name}: the "
                                 "control matched; the check sees nothing")
    for line in lines:
        if line["launches"] != line["expected_launches"]:
            raise AssertionError(
                f"model_axis {line['run']} rank {line['rank']}: launches "
                f"{line['launches']}, expected "
                f"{line['expected_launches']}")
        same = [x for x in lines if x["run"] == line["run"]]
        if any(x["losses"] != line["losses"] for x in same):
            raise AssertionError(f"model_axis {line['run']}: the ranks' "
                                 "losses differ")
        if sum(x["N_m"] for x in same
               if x["coords"][0] == 0) != line["N"]:
            raise AssertionError(f"model_axis {line['run']}: the shards "
                                 "do not add up to N")
    summary = {"phase": "model_axis", "backend": backend, "ranks": ranks,
               "cards": cards, "model": model, "job_seconds": job_s,
               "codec_check": {name: {
                   "bitwise_equal": True, "control_mismatch_frac": sum(
                       x[name]["control_mismatches"] for x in checks)
                   / sum(x[name]["codes"] for x in checks)}
                   for name in ("int8", "int8_sr")}}
    for run in (*MA_RUNS, "f"):
        line = next(x for x in lines if x["run"] == run)
        rtol = (MA_CODEC_RTOL if MA_RUNS.get(run, ({},))[0].get("codec")
                else MR_RTOL)
        summary[run] = {
            "loss_single": single[run][0], "loss_ranks": line["losses"],
            **_ma_check(run, line["losses"], single[run][0], params[run],
                        single[run][1], rtol),
            "single_round_seconds": single[run][2],
            "single_peak_gib": single[run][3],
            "rank_peak_gib": [x["peak_gib"] for x in lines
                              if x["run"] == run]}
    # (f) trains tensor-parallel: no whole-model exchange on any rank
    for line in (x for x in lines if x["run"] == "f"):
        if (line["route"] != "tensor_parallel"
                or set(line["collective_ms_per_round"])
                & {"param_all_gather", "all_to_all"}):
            raise AssertionError(
                f"model_axis f rank {line['rank']}: route {line['route']}, "
                f"collectives {sorted(line['collective_ms_per_round'])}")
    summary["e"] = {"loss_resumed": resumed[0], **_ma_check(
        "e", resumed[0], single["a"][0][MA_CUT:], resumed[1],
        single["a"][1], MR_RTOL), "params_max_rel_vs_ranks": _ma_check(
        "e vs ranks", resumed[0], single["a"][0][MA_CUT:], resumed[1],
        params["a"], MR_RTOL)["params_max_rel"]}
    summary["seconds"] = time.perf_counter() - tic
    emit(summary)


AR_ROUNDS = 4
AR_CUT = 2
AR_WORKER = "--async-ranks-worker"
# run -> (codec with error feedback or None, on the (clients, model)
# mesh?, guard?): int8 and int8_sr on the client axis (a, b) and on the
# mesh (c, d); (e) f32 arrivals under the guard on the mesh, cut
# mid-buffer at round 2
AR_RUNS = {"a": ("int8", False, False), "b": ("int8_sr", False, False),
           "c": ("int8", True, False), "d": ("int8_sr", True, False),
           "e": (None, True, True)}


def _ar_trainer(task, run, k, model, resume_from=None):
    """An async_ranks run: ResNet18-GN FedDPC under ExponentialRuntime,
    two waves in flight, B = K / 2; ``model`` None is one process, else
    the ranks as (ranks // model, model)."""
    codec, _, guard = AR_RUNS[run]
    kw = {**NO_EVAL, "clients_per_round": k, "async_buffer": True,
          "buffer_size": k // 2, "async_concurrency": 2, "guard": guard}
    if codec is not None:
        kw.update(codec=codec, codec_ef=True)
    if model is not None:
        kw.update(shard_clients=True, shard_model=model)
    return _trainer(*task, "feddpc", AR_ROUNDS, "cuda", kw,
                    runtime=ExponentialRuntime(mean=1.0),
                    sampler=UniformSampler(MR_CLIENTS, k),
                    resume_from=resume_from)


class _PopLog:
    """The async engine module's ``heapq`` with every pop logged: the
    arrivals' (client, wave, version), in arrival order."""

    def __init__(self, heapq_module):
        self._heapq = heapq_module
        self.log = []

    def __getattr__(self, name):
        return getattr(self._heapq, name)

    def heappop(self, heap):
        item = self._heapq.heappop(heap)
        e = item[2]
        self.log.append([int(e.client), int(e.wave), int(e.version)])
        return item


def _record_folds(tr):
    """Each fold of ``tr``'s engine: its arrivals and, across ranks, the
    buffer positions this rank held (the list the folds land in)."""
    if not isinstance(async_engine.heapq, _PopLog):
        async_engine.heapq = _PopLog(async_engine.heapq)
    log, eng = async_engine.heapq.log, tr._engine
    run, fold = eng.run_server_round, eng.fold
    folds = []

    def recorded(t, params, server_state):
        mark = len(log)
        out = run(t, params, server_state)
        folds[-1]["arrivals"] = log[mark:]
        return out

    def held_fold(*a, held=None, **kw):
        folds.append({"held": None if held is None else len(held)})
        return fold(*a, held=held, **kw)
    eng.run_server_round, eng.fold = recorded, held_fold
    return folds


def _ar_expected(run, folds, waves):
    """Launches a rank's run implies: a reduction pass (the guard's under
    the guard) and a buffer fold (the dequant fold with a codec) a fold
    in which it held arrivals; int8_sr's encode once a wave."""
    codec, _, guard = AR_RUNS[run]
    held = sum(1 for f in folds if f["held"])
    out = {"feddpc_guard_dots" if guard else "feddpc_dots": held,
           "feddpc_dequant_buffer_fold" if codec else "feddpc_buffer_fold":
           held}
    if codec == "int8_sr":
        out["int8_sr_quantize"] = waves
    return {k: v for k, v in out.items() if v}


def _async_ranks_worker(out: str) -> int:
    """One rank of the async_ranks phase: runs (a)-(e), (e) saved at
    round 2 (rank 0 writes the checkpoint) and run on to its end; writes
    its lines and rank 0's gathered params."""
    ctx = distributed.maybe_initialize()
    torch.backends.cudnn.deterministic = True
    task = _mr_task()
    k = mr_cohort(ctx.num_processes)
    lines = []
    for run, (_, on_mesh, _) in AR_RUNS.items():
        _ma_reset()
        inflight = []
        with _ar_trainer(task, run, k, MA_MODEL if on_mesh else 1) as tr:
            folds = _record_folds(tr)
            for t in range(AR_ROUNDS):
                if run == "e" and t == AR_CUT:
                    tr.save(os.path.join(out, "ckpt"))
                tr.run_round(t)
                inflight.append(tr.shard_info()["bytes"]["inflight"])
            tr.finalize()
            full = tr.full_params()
        info = tr.shard_info()
        coll = collections.defaultdict(
            lambda: [0.0] * len(tr.collective_log))
        for i, rnd in enumerate(tr.collective_log):
            for name, ms in rnd:
                coll[name][i] += ms
        lines.append({
            "phase": "async_ranks", "run": run, "rank": ctx.process_id,
            "backend": ctx.backend, "mesh": info["mesh"],
            "coords": info["coords"], "N": info["N"], "N_m": info["N_m"],
            "slice_rows": info["slice_rows"],
            "bytes_at_rest": info["bytes"], "inflight_bytes": inflight,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": _ma_launches(),
            "expected_launches": _ar_expected(run, folds,
                                              tr._engine.wave_frontier),
            "held_per_fold": [f["held"] for f in folds],
            "collective_ms_per_round": dict(coll),
            "round_seconds": [r.seconds for r in tr.history],
            "losses": [r.train_loss for r in tr.history],
            "arrivals": [f["arrivals"] for f in folds]})
        if ctx.process_id == 0:
            torch.save(full.cpu(), os.path.join(out, f"{run}.pt"))
        del tr, full
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out, f"rank{ctx.process_id}.json"), "w") as fh:
        json.dump(lines, fh)
    return 0


def phase_async_ranks():
    """Buffered-async rounds across ranks at full width: multirank's
    ResNet18-GN task (K = mr_cohort(ranks): no wave is padded, so int8_sr
    draws one process's noise), ExponentialRuntime, two waves in flight,
    B = K / 2, 4 rounds, deterministic cuDNN, on ma_layout's ranks: async
    int8 + EF and int8_sr + EF on the client axis (ranks x 1) and on the
    (ranks / 2 x 2) mesh, guarded f32 arrivals on the mesh cut at round 2
    and resumed in this process. Each run is held against this process's
    one-process run (losses and params within MR_RTOL, the codec runs
    within MA_CODEC_RTOL), every fold's arrivals equal to one process's,
    each rank's launches against the arrivals it held. Returns the
    launches each kernel made on the ranks."""
    cards = torch.cuda.device_count()
    ranks, backend = ma_layout(cards)
    k = mr_cohort(ranks)
    tic = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    single = {}
    try:
        task = _mr_task()
        for run in ("a", "b", "e"):
            torch.cuda.reset_peak_memory_stats()
            with _ar_trainer(task, run, k, None) as tr:
                folds = _record_folds(tr)
                tr.run()
            single[run] = ([r.train_loss for r in tr.history],
                           tr.flat.cpu(), [r.seconds for r in tr.history],
                           torch.cuda.max_memory_allocated() / 2 ** 30,
                           [f["arrivals"] for f in folds])
            del tr
        single["c"], single["d"] = single["a"], single["b"]
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ar_") as out:
            env = {}
            if backend == "nccl":
                env["NCCL_SOCKET_IFNAME"] = os.environ.get(
                    "NCCL_SOCKET_IFNAME", "lo")
            job_tic = time.perf_counter()
            distributed.spawn_local(
                [sys.executable, os.path.abspath(__file__), AR_WORKER, out],
                ranks, backend=backend,
                local_devices=1 if backend == "gloo" else None, env=env,
                timeout_s=480)
            job_s = time.perf_counter() - job_tic
            lines = []
            for r in range(ranks):
                with open(os.path.join(out, f"rank{r}.json")) as fh:
                    lines += json.load(fh)
            params = {run: torch.load(os.path.join(out, f"{run}.pt"))
                      for run in AR_RUNS}
            with _ar_trainer(task, "e", k, None,
                             resume_from=os.path.join(out, "ckpt")) as res:
                if (res.start_round != AR_CUT
                        or not res._engine.inflight()):
                    raise AssertionError(
                        f"async_ranks e: resumed at {res.start_round} "
                        f"with {len(res._engine.inflight())} in flight")
                res.run()
            resumed = ([r.train_loss for r in res.history[AR_CUT:]],
                       res.flat.cpu())
            del res
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = collections.Counter()
    for line in lines:
        run = line["run"]
        arrivals = line.pop("arrivals")
        emit(line)
        if arrivals != single[run][4]:
            raise AssertionError(f"async_ranks {run} rank {line['rank']}: "
                                 "the folds' arrivals differ from one "
                                 "process's")
        if line["launches"] != line["expected_launches"]:
            raise AssertionError(
                f"async_ranks {run} rank {line['rank']}: launches "
                f"{line['launches']}, expected {line['expected_launches']}")
        if any(x["losses"] != line["losses"] for x in lines
               if x["run"] == run):
            raise AssertionError(f"async_ranks {run}: the ranks' losses "
                                 "differ")
        launches.update(line["launches"])
    summary = {"phase": "async_ranks", "backend": backend, "ranks": ranks,
               "cards": cards, "clients_per_round": k,
               "buffer_size": k // 2, "job_seconds": job_s}
    for run, (codec, _, _) in AR_RUNS.items():
        line = next(x for x in lines if x["run"] == run)
        summary[run] = {
            "mesh": line["mesh"], "loss_single": single[run][0],
            "loss_ranks": line["losses"],
            **_ma_check(f"async_ranks {run}", line["losses"],
                        single[run][0], params[run], single[run][1],
                        MA_CODEC_RTOL if codec else MR_RTOL),
            "single_round_seconds": single[run][2],
            "single_peak_gib": single[run][3],
            "rank_peak_gib": [x["peak_gib"] for x in lines
                              if x["run"] == run],
            "rank_inflight_bytes": [x["inflight_bytes"][-1] for x in lines
                                    if x["run"] == run]}
    summary["e_resumed"] = {"loss_resumed": resumed[0], **_ma_check(
        "async_ranks e resumed", resumed[0], single["e"][0][AR_CUT:],
        resumed[1], single["e"][1], MR_RTOL)}
    summary["rank_launches"] = dict(launches)
    summary["seconds"] = time.perf_counter() - tic
    emit(summary)
    return dict(launches)


def _parity_checkpoint(task):
    """LeNet5: a checkpoint written on the card resumes on the CPU and one
    written on the CPU resumes on the card; each resumed run continues
    within PARITY_ATOL of the CPU's uninterrupted run."""
    mk = functools.partial(_trainer, *task, "feddpc", 4)
    with mk("cpu") as cpu_full:
        cpu_full.run()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parity_") as root:
        for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
            d = os.path.join(root, src)
            part = mk(src)
            for t in range(2):
                part.run_round(t)
            part.save(d)
            part.close()
            res = mk(dst, resume_from=d)
            if (res.flat.device.type != dst
                    or not torch.equal(res.flat.cpu(), part.flat.cpu())):
                raise AssertionError(f"parity checkpoint {src} -> {dst}: "
                                     "params not restored bit for bit")
            with res:
                hist = res.run()
            diffs = [abs(a.train_loss - b.train_loss)
                     for a, b in zip(hist, cpu_full.history)]
            emit({"phase": "parity", "run": f"checkpoint_{src}_to_{dst}",
                  "model": task[0].name, "start_round": res.start_round,
                  "loss_resumed": [r.train_loss for r in hist],
                  "loss_cpu": [r.train_loss for r in cpu_full.history],
                  "max_loss_diff": max(diffs),
                  "max_param_diff": float((res.flat.cpu()
                                           - cpu_full.flat).abs().max())})
            if len(hist) != 4 or not max(diffs) <= PARITY_ATOL:
                raise AssertionError(f"parity checkpoint {src} -> {dst}: "
                                     f"losses differ by {max(diffs)}")


def _attention_case(gen, case, dtype):
    """The inputs of one FA_CASES entry on the card: q, k, v of dtype,
    int32 positions (queries at consecutive positions from q0; the cache
    slots rolled as a ring buffer when the first query is past Sk; or,
    with every key visible, queries at Sk and keys at 0..Sk-1)."""
    (_, b, sq, sk, h, kv, d, window, soft_cap, empty, q0,
     empty_row, *all_visible) = case
    q, k, v = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]
    if all_visible and all_visible[0]:
        q_pos = torch.full((b, sq), sk, dtype=torch.int32, device="cuda")
        k_pos = torch.arange(sk, dtype=torch.int32,
                             device="cuda")[None].repeat(b, 1)
        return q, k, v, q_pos, k_pos
    if soft_cap:
        q = q * 6                     # scores well past the cap
    q_pos = torch.arange(q0, q0 + sq, dtype=torch.int32,
                         device="cuda")[None].repeat(b, 1)
    last = q0 + sq - 1                # the cache holds positions <= last
    k_pos = torch.arange(last - sk + 1 + empty, last + 1 + empty,
                         dtype=torch.int32, device="cuda")
    k_pos = torch.where(k_pos > last, -1, k_pos)   # empty trailing slots
    if q0 + sq > sk:                  # a ring buffer that has wrapped
        k_pos = torch.roll(k_pos, int(q0 % sk))
    k_pos = k_pos[None].repeat(b, 1)
    if empty_row:
        k_pos[1] = -1
    return q, k, v, q_pos, k_pos


def _visible(q_pos, k_pos, window):
    ok = (k_pos[:, None, :] <= q_pos[:, :, None]) & (k_pos[:, None, :] >= 0)
    if window:
        ok &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    return ok                          # (B, Sq, Sk)


def _sdpa_library(q, k, v, ok):
    """torch's scaled_dot_product_attention on the same function, in its
    (B, H, S, D) layout with a boolean mask: the yardstick, never on the
    port's path."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = ok[:, None]

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    return call


def phase_attention():
    """flash_attention against its plain version at every FA_CASES shape
    in f32 and bf16, then timed at the serving path's prefill and decode
    shapes; returns the kernel's summary row. A case that fails a check
    is printed untimed, and the phase raises after the last case."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    steps = 0.0
    timings, failures = [], []
    for case, dtype in itertools.product(FA_CASES, (torch.float32,
                                                    torch.bfloat16)):
        label, b, sq, sk, h, kv, d, window, soft_cap = case[:9]
        q, k, v, q_pos, k_pos = _attention_case(gen, case, dtype)
        kw = {"window": window, "soft_cap": soft_cap}
        got = fa_ops.flash_attention(q, k, v, q_pos, k_pos, **kw)
        want = fa_ref.attention_ref(q, k, v, q_pos, k_pos, **kw)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        tol = FA_TOL[dtype]
        ok = _visible(q_pos, k_pos, window)
        dark = ~ok.any(dim=-1)                       # rows with no key
        route = fa_ops.plan(q.shape, k.shape, dtype,
                            torch.cuda.get_device_properties(0)
                            .multi_processor_count)
        line = {"phase": "attention", "case": label, "B": b, "Sq": sq,
                "Sk": sk, "H": h, "KV": kv, "D": d, "window": window,
                "soft_cap": soft_cap, "dtype": str(dtype)[6:],
                "route": route[0], "chunk": route[1], "splits": route[2],
                "rows_without_keys": int(dark.sum()), "max_abs_err": e,
                "within_fa_tol": got.dtype == dtype and torch.allclose(
                    got.float(), want.float(), rtol=tol, atol=tol),
                "dark_rows_zero": not bool((got.float()[dark] != 0).any())}
        if dtype == torch.bfloat16:
            line["bf16_steps"] = fa_ref.bf16_steps(got, want)
        failed = [name for name, bad in (
            ("FA_TOL", not line["within_fa_tol"]),
            ("BF16_STEPS_TOL", line.get("bf16_steps", 0) > BF16_STEPS_TOL),
            ("a row with no visible key is not exactly 0",
             not line["dark_rows_zero"])) if bad]
        if failed:
            line["failed"] = failed
            failures.append(f"{label} {dtype}: {', '.join(failed)}")
        err[dtype] = max(err[dtype], e)
        steps = max(steps, line.get("bf16_steps", 0.0))
        if label in FA_TIMED and not failed:
            pairs = int(ok.sum())
            item = q.element_size()
            nbytes = (item * (2 * q.numel() + k.numel() + v.numel())
                      + 4 * (q_pos.numel() + k_pos.numel()))
            flops = 4 * d * h * pairs
            peak = (F32_FLOP_PER_S if dtype == torch.float32
                    else BF16_FLOP_PER_S)
            lib = _sdpa_library(q, k, v, ok)
            lib_err = float((lib().transpose(1, 2).float()
                             - want.float()).abs().max())
            kern = functools.partial(fa_ops.flash_attention, q, k, v, q_pos,
                                     k_pos, **kw)
            ms, ms_one = cuda_ms(kern)
            plain_ms, _ = cuda_ms(functools.partial(
                fa_ref.attention_ref, q, k, v, q_pos, k_pos, **kw))
            b_ms, b_by = bound_ms(nbytes, flops, peak)
            line.update({
                "ms": ms, "ms_one_call": ms_one,
                "ms_cold": cuda_ms_cold(kern),
                "ms_cold_spin": cuda_ms_cold(kern, spin=True),
                "plain_ms": plain_ms,
                "library_ms": cuda_ms(lib)[0], "library_max_abs_err": lib_err,
                "bound_ms": b_ms, "bound_by": b_by,
                "pct_of_bound": 100.0 * b_ms / ms,
                "peak_flop_per_s": peak, "bytes": nbytes, "flops": flops,
                "visible_pairs": pairs})
            timings.append(line)
        emit(line)
        del q, k, v, got, want
    if failures:
        raise AssertionError("flash_attention vs its plain version: "
                             + "; ".join(failures))
    head = timings[0]                  # prefill, f32: the headline
    return {"name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
            "replaces": FA_REPLACES, "max_abs_err": err[torch.float32],
            "max_abs_err_bf16": err[torch.bfloat16],
            "max_bf16_steps": steps, "ms": head["ms"],
            "ms_one_call": head["ms_one_call"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "(bool mask, enable_gqa)",
            "timings": [{k: t[k] for k in (
                "case", "dtype", "route", "ms", "ms_one_call", "ms_cold",
                "ms_cold_spin", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "pct_of_bound")} for t in timings]}


def _ssm_case(gen, case, dtype):
    """The inputs of one SS_CASES entry on the card, drawn as the
    reference's sweep draws them: u (in dtype), dt = softplus(N) / 10,
    b, c ~ N, a = -exp(0.3 N), d_skip = 1, h0 ~ N when carried in."""
    _, b, s, d_in, n, with_h0 = case

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    u = randn(b, s, d_in).to(dtype)
    dt = torch.nn.functional.softplus(randn(b, s, d_in)) * 0.1
    bm, cm = randn(b, s, n), randn(b, s, n)
    a = -torch.exp(randn(d_in, n) * 0.3)
    dsk = torch.ones(d_in, device="cuda")
    return u, dt, bm, cm, a, dsk, (randn(b, d_in, n) if with_h0 else None)


def _ssm_fused(gen, args, dtype):
    """One SS_CASES entry's args (whose dt then stands for x_proj's raw dt)
    and the fused form's extra inputs, laid out as mamba_forward hands
    them over: z (in u's dtype) the second half of one (B, S, 2 D_in)
    in_proj output, and in f32 b and c slices of one (B, S, R + 2 N)
    x_proj output (R the model's dt rank; a bf16 model's .float() copies
    them); dt's bias near dt_proj's -4.6 (softplus^-1(0.01))."""
    u, dt, bm, cm, a, dsk, h0 = args
    bsz, s, d_in = u.shape
    n = bm.shape[-1]
    bias = torch.randn(d_in, generator=gen, device="cuda") * 0.5 - 4.6
    xz = torch.randn((bsz, s, 2 * d_in), generator=gen, device="cuda")
    z = (xz * 2).to(dtype)[..., d_in:]
    if dtype == torch.float32:
        rank = get_config(SSM_ARCH).resolved_dt_rank
        proj = torch.randn((bsz, s, rank + 2 * n), generator=gen,
                           device="cuda")
        proj[..., rank:rank + n], proj[..., rank + n:] = bm, cm
        bm, cm = proj[..., rank:rank + n], proj[..., rank + n:]
    return ((u, dt, bm, cm, a, dsk, h0),
            {"dt_bias": bias, "dt_softplus": True, "z": z})


def _ssm_work(u, dt, b, c, a, dsk, h0, dt_bias=None, dt_softplus=False,
              z=None):
    """(bytes, f32 FLOPs, SFU operations) of one scan: each input read
    once, y and h_final written once; per (batch, step, channel, state)
    dt*a, h*decay + du*b and acc + h*c (6 FLOPs) and one exp, per (batch,
    step, channel) du, d*u and the sum (3). The fused form also reads
    dt_bias and z, and per (batch, step, channel) adds the bias, max and
    add of the softplus (3 FLOPs, an exp and a log) and the gate's add,
    division and product (3 FLOPs, an exp)."""
    bsz, s, d_in = u.shape
    n = b.shape[-1]
    f32_elems = (dt.numel() + b.numel() + c.numel() + a.numel() + dsk.numel()
                 + bsz * d_in * n + (0 if h0 is None else h0.numel())
                 + (0 if dt_bias is None else dt_bias.numel()))
    nbytes = (2 * u.element_size() * u.numel() + 4 * f32_elems
              + (0 if z is None else z.element_size() * z.numel()))
    elems = bsz * s * d_in
    flops, sfu = 6 * elems * n + 3 * elems, elems * n
    if dt_bias is not None or dt_softplus:
        flops, sfu = flops + 3 * elems, sfu + 2 * elems
    if z is not None:
        flops, sfu = flops + 3 * elems, sfu + elems
    return nbytes, flops, sfu


def phase_ssm_kernels():
    """ssm_scan against its plain version at every SS_CASES shape in f32
    and bf16 (and the SS_FUSED shapes in the fused form), then timed at
    the serving path's prefill and decode shapes beside the bound; returns
    the kernel's summary row."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    clock_mhz = _max_sm_clock_mhz()
    sfu_per_s = SFU_PER_CLOCK_PER_SM * NUM_SMS * 1e6 * clock_mhz
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    err_h = 0.0
    timings = []
    for case, dtype in itertools.product(SS_CASES, (torch.float32,
                                                    torch.bfloat16)):
        label, b, s, d_in, n, with_h0 = case
        case_args = _ssm_case(gen, case, dtype)
        for fused in (False, True) if label in SS_FUSED else (False,):
            args, kw = (_ssm_fused(gen, case_args, dtype) if fused
                        else (case_args, {}))
            name = f"ssm_scan {label} {dtype}{' fused' if fused else ''}"
            y, h = ss_ops.ssm_scan(*args, **kw)
            want_y, want_h = ss_ref.ssm_scan_ref(*args, **kw)
            torch.cuda.synchronize()
            e = float((y.float() - want_y.float()).abs().max())
            e_h = float((h - want_h).abs().max())
            tol = SS_TOL[dtype]
            if y.dtype != dtype or not torch.allclose(
                    y.float(), want_y.float(), rtol=tol, atol=tol):
                raise AssertionError(f"{name}: y max abs err {e}")
            if not torch.allclose(h, want_h, rtol=SS_H_TOL, atol=SS_H_TOL):
                raise AssertionError(f"{name}: h max abs err {e_h}")
            err[dtype] = max(err[dtype], e)
            err_h = max(err_h, e_h)
            line = {"phase": "ssm_kernels", "case": label, "fused": fused,
                    "B": b, "S": s, "D_in": d_in, "N": n, "h0": with_h0,
                    "dtype": str(dtype)[6:], "max_abs_err": e,
                    "h_max_abs_err": e_h,
                    # the kernel rounds as the plain version does (csrc)
                    "bitwise_equal": bool(torch.equal(y, want_y)
                                          and torch.equal(h, want_h))}
            if label in SS_TIMED:
                nbytes, flops, sfu = _ssm_work(*args, **kw)
                b_ms, b_by = bound_ms(nbytes, flops, sfu_ops=sfu,
                                      sfu_per_s=sfu_per_s)
                term = ("bytes" if b_by == "bytes" else "SFU (exp, log)"
                        if sfu / sfu_per_s >= flops / F32_FLOP_PER_S
                        else "f32 FLOPs")
                kern = functools.partial(ss_ops.ssm_scan, *args, **kw)
                plain = functools.partial(ss_ref.ssm_scan_ref, *args, **kw)
                ms, ms_one = cuda_ms(kern)
                # the plain version launches ~8 kernels a step: few windows
                plain_ms, _ = cuda_ms(plain, reps=3, calls=1) if s > 1 \
                    else cuda_ms(plain)
                line.update({
                    "ms": ms, "ms_one_call": ms_one,
                    "ms_cold": cuda_ms_cold(kern),
                    "ms_cold_spin": cuda_ms_cold(kern, spin=True),
                    "plain_ms": plain_ms,
                    "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                    "bound_term": term, "bytes": nbytes, "flops": flops,
                    "sfu_ops": sfu, "max_sm_clock_mhz": clock_mhz})
                timings.append(line)
            emit(line)
            del y, h, want_y, want_h, args, kw
        del case_args
    # the headline: the prefill in f32 in the fused form, the call the
    # serving path makes
    head = next(t for t in timings if t["case"] == "prefill"
                and t["dtype"] == "float32" and t["fused"])
    return {"name": "ssm_scan", "route": "cuda", "source": SS_SOURCE,
            "replaces": SS_REPLACES, "max_abs_err": err[torch.float32],
            "max_abs_err_bf16": err[torch.bfloat16], "h_max_abs_err": err_h,
            "ms": head["ms"], "ms_one_call": head["ms_one_call"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "library": LIBRARY_NONE,
            "timings": [{k: t[k] for k in (
                "case", "dtype", "fused", "ms", "ms_one_call", "ms_cold",
                "ms_cold_spin", "plain_ms", "bound_ms", "bound_by",
                "bound_term", "bitwise_equal")} for t in timings]}


def _patch_prefix(cfg, b, dtype, device):
    """(P, zero patch embeddings (B, P, D) or None): a VLM's prefix as
    serve_lm feeds it (the stub's shape), none for a text model."""
    if cfg.modality != "vision":
        return 0, None
    return cfg.num_patches, torch.zeros((b, cfg.num_patches, cfg.d_model),
                                        dtype=dtype, device=device)


def _teacher_forced(cfg, params, prompts, forced, impl):
    """Prefill ``prompts`` (after a VLM's zero patch prefix), then one
    decode step per column of ``forced`` (the same tokens whatever the
    model predicts): the last-position logits of each, stacked (1 +
    steps, B, V) in f32. ``impl`` ("auto" or "reference") is both the
    attention's and the SSM mixer's."""
    b, s = prompts.shape
    steps = forced.shape[1]
    dtype = params["embed"].dtype
    p, embeds = _patch_prefix(cfg, b, dtype, prompts.device)
    states = tf.init_states(cfg, b, p + s + steps, dtype, prompts.device)
    with torch.inference_mode():
        logits, states, _ = tf.lm_forward(cfg, params, prompts,
                                          embeds=embeds, states=states,
                                          attn_impl=impl, ssm_impl=impl,
                                          logits_slice_last=True)
        out = [logits[:, -1].float()]
        for i in range(steps):
            pos = torch.full((b, 1), p + s + i, dtype=torch.int32,
                             device=prompts.device)
            logits, states, _ = tf.lm_forward(
                cfg, params, forced[:, i:i + 1], positions=pos,
                states=states, attn_impl=impl, ssm_impl=impl,
                logits_slice_last=True)
            out.append(logits[:, -1].float())
    return torch.stack(out)


def _serve_category(kernel: str) -> str:
    if any(name in kernel for name in FA_KERNEL_NAMES):
        return "flash_attention kernel"
    if any(name in kernel for name in SS_KERNEL_NAMES):
        return "ssm_scan kernel"
    if any(tag in kernel.lower() for tag in ("gemm", "gemv", "cutlass",
                                             "xmma", "cublas", "nvjet")):
        return "matmuls (cuBLAS)"
    if "at::native" in kernel:
        return "PyTorch elementwise, norms, copies"
    return "other"


def _profiled(fn, retry=False):
    """fn() under torch.profiler, inference mode, its work synchronized,
    between a lead and a tail (PROFILE_RETRY's when ``retry``): (profile,
    window seconds, fn's result, the flash wrapper's launches in it)."""
    wait_s, pads = PROFILE_RETRY if retry else (PROFILE_TAIL_S,
                                                PROFILE_PAD)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    launched = fa_ops.flash_attention.launches
    with torch.inference_mode(), torch.profiler.profile(
            activities=acts) as prof:
        _profile_lead(pads)
        tic = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - tic
        _profile_tail(window_s, wait_s, pads)
    return prof, window_s, result, fa_ops.flash_attention.launches - launched


def _profile_step(cfg, params, tok, pos, states, embeds=None, retry=False):
    """One forward step under torch.profiler (``_profiled``), its result
    (next token, new states). The step can be run again on the same
    arguments: the attention caches are written in place at the same
    slots with the same values, the SSM states are replaced."""
    def step():
        logits, new_states, _ = tf.lm_forward(
            cfg, params, tok, positions=pos, embeds=embeds, states=states,
            logits_slice_last=True)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], new_states
    return _profiled(step, retry)


def _step_launches(cfg, step: str) -> dict:
    """Serving kernels one forward of ``cfg``'s decoder launches: every
    attention layer's flash call (prefill and decode, but for MLA's
    absorbed decode, which is plain f32 einsums as in the reference) and
    every SSM layer's scan."""
    kinds = [kind for kind, _ in tf.layer_specs(cfg)]
    flash = (kinds.count("attn")
             if step == "prefill" or cfg.attention != "mla" else 0)
    return {"flash_attention": flash, "ssm_scan": kinds.count("ssm")}


def _serve_want(cfg, gen: int) -> dict:
    """A serve_lm run's launches: one prefill and gen - 1 decode steps."""
    pre, dec = _step_launches(cfg, "prefill"), _step_launches(cfg, "decode")
    return {name: pre[name] + (gen - 1) * dec[name] for name in pre}


def _silu_ops(cfg) -> int:
    """silu ops a forward: each Mamba mixer's conv (the gate's is folded
    into the scan), each SwiGLU MLP, each MoE layer's experts and shared
    experts."""
    n = 0
    for kind, is_moe in tf.layer_specs(cfg):
        n += kind == "ssm"
        if cfg.arch_type == "ssm":
            continue
        if is_moe:
            n += 1 + bool(cfg.num_shared_experts)
        elif cfg.mlp == "swiglu":
            n += 1
    return n


def _check_profiled_step(label, step, profiled, want_flash, want_mixer):
    """``profiled(retry)`` -> (profile, window s, result, flash launches):
    run it, then once more on the same inputs, with PROFILE_RETRY's lead
    and tail, if the device count is off (the profiler can drop device
    events at either end of its window). Host counts must be exact on
    every read. Returns the exact read's numbers, its ``result`` and every
    read's device counts and pads seen (``reads``)."""
    reads = []
    for retry in (False, True):
        prof, window_s, result, launched = profiled(retry)
        spans, busy_us, by_name, by_cat = _kernel_time(prof.events(),
                                                       _serve_category)
        flash = sum(1 for *_, name in spans
                    if _serve_category(name) == "flash_attention kernel")
        ops = {key: sum(1 for e in prof.events()
                        if e.device_type == DeviceType.CPU
                        and e.key == f"aten::{key}")
               for key in ("log1p", "silu")}
        mixer = {key: sum(1 for *_, name in spans if key in name)
                 for key in ("log1p", "silu")}
        if launched != want_flash:
            raise AssertionError(f"{label} profile {step}: {launched} "
                                 "flash-attention launches, expected "
                                 f"{want_flash}")
        if want_mixer is not None and ops != want_mixer:
            raise AssertionError(f"{label} profile {step}: mixer ops "
                                 f"{ops}, expected {want_mixer}")
        pads = _pads_seen(prof.events())
        reads.append({"kernels": len(spans),
                      "lead_pads_seen": pads["lead"],
                      "tail_pads_seen": pads["tail"],
                      "pads_each_end": PROFILE_RETRY[1] if retry
                      else PROFILE_PAD,
                      "flash_attention_kernels": flash,
                      **{f"{key}_kernels": n for key, n in mixer.items()}})
        if flash == want_flash and (want_mixer is None
                                    or mixer == want_mixer):
            return {"window_s": window_s, "result": result,
                    "launched": launched, "kernels": len(spans),
                    "busy_us": busy_us, "by_name": by_name,
                    "by_cat": by_cat, "flash": flash, "mixer": mixer,
                    "ops": ops, "reads": reads}
    raise AssertionError(f"{label} profile {step}: device kernels {reads} "
                         f"in two profiles, expected {want_flash} "
                         "flash-attention"
                         + (f" and {want_mixer}" if want_mixer else ""))


def _emit_profile(arch, dtype, step, read):
    top = sorted(read["by_name"].items(), key=lambda kv: kv[1],
                 reverse=True)[:6]
    emit({"phase": "serve_profile", "arch": arch, "dtype": dtype,
          "step": step, "window_ms": 1e3 * read["window_s"],
          "kernels": read["kernels"],
          "flash_attention_kernels": read["flash"],
          "flash_attention_launches": read["launched"],
          **{f"{key}_kernels": n for key, n in read["mixer"].items()},
          **{f"{key}_ops": n for key, n in read["ops"].items()},
          "device_reads": read["reads"],
          "device_busy_ms": read["busy_us"] / 1e3,
          "device_idle_share": 1.0 - read["busy_us"] / 1e6
          / read["window_s"],
          "by_category_ms": read["by_cat"],
          "top_ms": [[name[:70], ms] for name, ms in top]})
    if step == "decode":
        emit({"phase": "serve_decode_launches", "arch": arch,
              "dtype": dtype, "launches_per_step": read["kernels"]})


def profile_serve(cfg, params, prompts):
    """One prefill and one decode step under torch.profiler (after
    serve_lm has warmed both): per step the window's wall time, the
    card's busy time (the union of kernel intervals) and idle share,
    kernel time by category and the launches per step. Each step must
    launch, and hold on the device, exactly the flash-attention kernels
    of ``_step_launches``; with SSM layers, no log1p and ``_silu_ops``
    silu, as torch ops and as device kernels. Host counts are exact on
    every read; where the profiler's device count is off, the step is
    profiled once more on the same inputs and must be exact there (both
    reads are printed). Then one more decode step in which any call that
    waits for the card raises."""
    b, s = prompts.shape
    p, embeds = _patch_prefix(cfg, b, params["embed"].dtype, "cuda")
    states = tf.init_states(cfg, b, p + s + 2, params["embed"].dtype,
                            "cuda")
    dtype = str(params["embed"].dtype)[6:]
    # the mixer's eager softplus chain (its log1p) and gate (a second
    # silu a layer) are folded into the scan
    want_mixer = ({"log1p": 0, "silu": _silu_ops(cfg)}
                  if _step_launches(cfg, "prefill")["ssm_scan"] else None)
    tok, pos = prompts, None
    for step in ("prefill", "decode"):
        read = _check_profiled_step(
            cfg.name, step,
            functools.partial(_profile_step, cfg, params, tok, pos, states,
                              embeds if step == "prefill" else None),
            _step_launches(cfg, step)["flash_attention"], want_mixer)
        _emit_profile(cfg.name, dtype, step, read)
        tok, states = read["result"]
        pos = torch.full((b, 1), p + s, dtype=torch.int32, device="cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            tf.lm_forward(cfg, params, tok, positions=pos + 1, states=states,
                          logits_slice_last=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# the serving paths' kernels: name -> the module of its wrapper
SERVE_KERNELS = {"flash_attention": fa_ops, "ssm_scan": ss_ops}


def _serve_launches() -> dict:
    return {name: getattr(mod, name).launches
            for name, mod in SERVE_KERNELS.items()}


def _reset_serve_launches():
    for mod in SERVE_KERNELS.values():
        mod.reset_launches()


def _gates(label, dtype, kern, plain):
    """Kernel path against plain path, (steps, B, V) f32 logits: (the
    line's fields, the failure or None) — f32 within SERVE_F32_RTOL x
    max|logit|, bf16 top-1 >= SERVE_BF16_TOP1, all finite."""
    finite = bool(torch.isfinite(kern).all() & torch.isfinite(plain).all())
    diff = float((kern - plain).abs().max())
    scale = max(1.0, float(plain.abs().max()))
    top1 = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    fields = {"kernel_vs_plain_max_abs_logit_diff": diff,
              "max_abs_logit": float(plain.abs().max()),
              "kernel_vs_plain_top1_agreement": top1,
              "logits_finite": finite}
    failure = None
    if not finite:
        failure = f"{label} {dtype}: non-finite logits"
    elif dtype == torch.float32 and not diff <= SERVE_F32_RTOL * scale:
        failure = (f"{label} f32: kernel vs plain logits differ by {diff} "
                   f"> {SERVE_F32_RTOL} x {scale}")
    elif dtype == torch.bfloat16 and not top1 >= SERVE_BF16_TOP1:
        failure = (f"{label} bf16: kernel vs plain top-1 agreement {top1} "
                   f"< {SERVE_BF16_TOP1}")
    return fields, failure


def _check_tokens(label, tokens, shape, vocab):
    if tuple(tokens.shape) != shape or not bool(
            ((tokens >= 0) & (tokens < vocab)).all()):
        raise AssertionError(f"{label}: tokens {tuple(tokens.shape)} out of "
                             "range")


# what phase_serve drives for one model family: its params, serve() ->
# (tokens, stats), the launches a run must make, profile(), forced(forced
# tokens, impl) -> teacher-forced logits, the serve line's own fields, and
# the decode steps a run's decode_s covers
ServeRun = collections.namedtuple(
    "ServeRun", "params serve want profile forced fields decode_steps")


def _lm_run(cfg, gen, dtype) -> ServeRun:
    """A decoder: random params and SERVE_B prompts of SERVE_PROMPT tokens
    from ``gen``, served by serve_lm."""
    params = tf.init_lm(cfg, gen, dtype)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                            generator=gen, device="cuda")
    return ServeRun(
        params,
        lambda: serve_lm(cfg, SERVE_B, SERVE_PROMPT, SERVE_GEN,
                         device="cuda", dtype=dtype, params=params,
                         prompts=prompts),
        _serve_want(cfg, SERVE_GEN),
        lambda: profile_serve(cfg, params, prompts),
        lambda forced, impl: _teacher_forced(cfg, params, prompts, forced,
                                             impl),
        {"layer_specs": tf.layer_specs(cfg),
         "patches": cfg.num_patches if cfg.modality == "vision" else 0,
         "prompt_len": SERVE_PROMPT},
        SERVE_GEN - 1)


def _encdec_run(cfg, gen, dtype) -> ServeRun:
    """The encoder-decoder: random params and SERVE_B clips of random
    frames from ``gen``, served by serve_encdec (from BOS): the encoder's
    layers launch once, then each decoder layer twice a step (self- and
    cross-attention)."""
    params = encdec.init_encdec(cfg, gen, dtype)
    frames = torch.randn((SERVE_B, cfg.encoder_seq_len, cfg.d_model),
                         generator=gen, device="cuda").to(dtype)
    return ServeRun(
        params,
        lambda: serve_encdec(cfg, SERVE_B, SERVE_GEN, device="cuda",
                             dtype=dtype, params=params, frames=frames),
        {"flash_attention": cfg.encoder_layers
         + 2 * cfg.num_layers * SERVE_GEN, "ssm_scan": 0},
        lambda: profile_serve_encdec(cfg, params, frames),
        lambda forced, impl: _encdec_teacher_forced(cfg, params, frames,
                                                    forced, impl),
        {"encoder_layers": cfg.encoder_layers,
         "frames": cfg.encoder_seq_len},
        SERVE_GEN)


def phase_serve(arch: str, kernel: str, dtypes=(torch.float32,
                                                torch.bfloat16),
                cut=None) -> int:
    """serve_lm (serve_encdec for the encoder-decoder) on ``arch`` at full
    width — full depth, or the config ``.with_(**cut)`` —, in each of
    ``dtypes``, with the serving kernels' counts set to 0 just before each
    run and read just after: they must be the run's ``want`` exactly.
    Then a profiled prefill (encode) and decode step, and the kernel path
    against the plain path on the same params and inputs (each timed).
    Returns the first run's launch count of ``kernel``."""
    cfg = get_config(arch).with_(**(cut or {}))
    make_run = _encdec_run if cfg.is_encoder_decoder else _lm_run
    counts = {}
    for dtype in dtypes:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(0)
        tic = time.perf_counter()
        run = make_run(cfg, gen, dtype)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - tic
        n_params = sum(t.numel() for t in tree_leaves(run.params))
        _reset_serve_launches()            # this path starts here
        tokens, stats = run.serve()
        launches = _serve_launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        if launches != run.want:
            raise AssertionError(f"serve {arch} {dtype}: launches "
                                 f"{launches}, expected {run.want}")
        _check_tokens(f"serve {arch} {dtype}", tokens, (SERVE_B, SERVE_GEN),
                      cfg.vocab_size)
        counts[dtype] = launches[kernel]
        run.profile()
        forced = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_STEPS),
                               generator=gen, device="cuda")
        path_s, logits = {}, {}
        for impl in ("auto", "reference"):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            logits[impl] = run.forced(forced, impl)
            torch.cuda.synchronize()
            path_s[impl] = time.perf_counter() - tic
        gates, failure = _gates(f"serve {arch}", dtype, logits["auto"],
                                logits["reference"])
        emit({"phase": "serve", "arch": cfg.name, "dtype": str(dtype)[6:],
              "layers": cfg.num_layers, "cut": cut or {},
              "d_model": cfg.d_model, "params": n_params, "init_s": init_s,
              "batch": SERVE_B, **run.fields, "gen": SERVE_GEN, **stats,
              "decode_step_ms": 1e3 * stats["decode_s"] / run.decode_steps,
              **{f"{name}_launches": n for name, n in launches.items()},
              "peak_memory_gib": peak_gib, "tokens_in_range": True,
              "sample": tokens[0, :8].tolist(),
              "parity_steps": 1 + SERVE_STEPS,
              "kernel_path_s": path_s["auto"],
              "plain_path_s": path_s["reference"], **gates})
        if failure:
            raise AssertionError(failure)
        del run, logits
    torch.cuda.empty_cache()
    return counts[dtypes[0]]


def phase_serve_parity(arch: str):
    """``arch``'s SMOKE config from the same params and tokens on the card
    and on the CPU: prefill plus SMOKE_STEPS teacher-forced decode
    steps."""
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = tf.init_lm(cfg, gen, torch.float32)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen)
    forced = torch.randint(0, cfg.vocab_size, (4, SMOKE_STEPS),
                           generator=gen)
    card = _teacher_forced(cfg, tree_map(lambda t: t.cuda(), params),
                           prompts.cuda(), forced.cuda(), "auto").cpu()
    cpu = _teacher_forced(cfg, params, prompts, forced, "auto")
    diff = float((card - cpu).abs().max())
    emit({"phase": "serve_parity", "arch": cfg.name, "steps": 1 + SMOKE_STEPS,
          "card_vs_cpu_max_abs_logit_diff": diff,
          "max_abs_logit": float(cpu.abs().max())})
    if not diff <= SMOKE_ATOL:
        raise AssertionError(f"{arch} SMOKE card vs CPU logits differ by "
                             f"{diff} > {SMOKE_ATOL}")


# ---- LM training: one client's local steps at full width, federated LM
# rounds (the reference example's ~101M run), the paper's quickstart, and
# the tiny LM example card vs CPU ----

LM_TRAIN_ARCH = "starcoder2-3b"
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS, LM_TRAIN_LR = 2, 1024, 3, 0.01
LM_FL_ROUNDS = 4
# the reference example's numbers for these 4 rounds (python
# examples/federated_llm_pretraining.py --rounds 4, JAX on the CPU): its
# losses rise over the first rounds at eta 0.05, and the port's must too
LM_FL_REFERENCE_LOSS = [10.198956, 12.759791, 12.111839, 31.315639]
LM_FL_REFERENCE_NLL = {0: 12.667036, 3: 14.620679}    # round -> holdout NLL
LM_FL_RTOL = 1e-4
LM_TINY_RTOL = 1e-4           # card vs CPU losses of the tiny LM example
QUICKSTART_ROUNDS = 15


def _lm_category(kernel: str) -> str:
    if any(tag in kernel for tag in ("dots_kernel", "fold_kernel",
                                     "epilogue_kernel")):
        return "feddpc kernels"
    if any(name in kernel for name in FA_KERNEL_NAMES):
        return "flash_attention kernel"
    if any(tag in kernel.lower() for tag in ("gemm", "gemv", "cutlass",
                                             "xmma", "cublas", "nvjet")):
        return "matmuls (cuBLAS)"
    if "at::native" in kernel:
        return "PyTorch elementwise and reductions"
    return "other"


def phase_lm_train():
    """One client's local training at full width and depth: StarCoder2-3B
    (30 layers, d_model 3072, f32, random weights from seed 0), B = 2
    sequences of 1,024 tokens, LM_TRAIN_STEPS SGD steps through
    launch/steps.make_train_step(remat="full") — plain autograd, each
    layer recomputed in the backward. The loss must be finite and fall,
    and the training route must launch no serving kernel (no backward in
    either package). Bound: 6·N·tokens (forward and backward) plus
    2·N·tokens (the recomputed forward) f32 FLOP at the f32 peak.
    Returns {"losses", "params" the steps end on} (tp_train holds its
    ranks against them)."""
    cfg = get_config(LM_TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_lm(cfg, gen, torch.float32)
    n_params = sum(t.numel() for t in tree_leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (LM_TRAIN_B, LM_TRAIN_S + 1),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    step = lm_steps.make_train_step(cfg, lr=LM_TRAIN_LR, remat="full")
    for mod in SERVE_KERNELS.values():
        mod.reset_launches()               # this path starts here
    losses, seconds = [], []
    for _ in range(LM_TRAIN_STEPS):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        params, loss = step(params, batch)
        losses.append(float(loss))         # a sync
        seconds.append(time.perf_counter() - tic)
    launches = _serve_launches()
    ntok = LM_TRAIN_B * LM_TRAIN_S
    flops = 8.0 * n_params * ntok
    bound, _ = bound_ms(0, flops)
    emit({"phase": "lm_train", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "params": n_params, "dtype": "float32",
          "batch": LM_TRAIN_B, "seq_len": LM_TRAIN_S, "remat": "full",
          "lr": LM_TRAIN_LR, "losses": losses, "step_seconds": seconds,
          "median_step_s": statistics.median(seconds[1:] or seconds),
          "tokens_per_s": ntok / statistics.median(seconds[1:] or seconds),
          "bound_s": bound / 1e3, "bound_flop": flops,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          **{f"{name}_launches": n for name, n in launches.items()}})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"lm_train: non-finite losses {losses}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"lm_train: the loss did not fall: {losses}")
    if any(launches.values()):
        raise AssertionError(f"lm_train: the training route launched "
                             f"serving kernels {launches}")
    del step
    torch.cuda.empty_cache()
    return {"losses": losses, "params": params}


TP_WORKER = "--tp-worker"
TP_RTOL = 1e-4          # losses, and each leaf against its max |w|
TP_MOVE_FRAC = 1e-2     # each leaf's error against how far it moved
TP_ONE_PROCESS = "one_process"      # lm_train's run, handed to the ranks
TP_FL_CLIENTS, TP_FL_COHORT, TP_FL_ROUNDS = 10, 5, 2
TP_FL_B, TP_FL_S = 2, 256
TP_FL_ETA = 0.01


def tp_layout(cards: int):
    """(ranks, backend) of the tp_train job: 2 gloo ranks on one card, 2
    NCCL ranks on two or three, 4 NCCL ranks on four or more."""
    if cards >= 4:
        return 4, "nccl"
    return 2, ("nccl" if cards >= 2 else "gloo")


def _tally(timings) -> dict:
    """[(collective, ms)] -> {collective: {"count", "ms"}}."""
    out = collections.defaultdict(lambda: {"count": 0, "ms": 0.0})
    for name, ms in timings:
        out[name]["count"] += 1
        out[name]["ms"] += ms
    return dict(out)


def _tp_lm_params(cfg, gen):
    """StarCoder2-3B's serving tree from ``gen`` (seed 0) and the batch
    drawn after it: the lm_train phase's params and tokens."""
    params = tf.init_lm(cfg, gen, torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (LM_TRAIN_B, LM_TRAIN_S + 1),
                           generator=gen, device="cuda")
    return params, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def reference_pieces(cfg, params):
    """The serving tree ``params`` (init_lm from a torch.Generator) in
    the order of the reference's tree (launch/steps.params_spec), whose
    flat vector make_train_step's shards cut: each leaf's tensors, a
    stacked leaf as its groups' layers one after another (views, no
    copy). Their concatenation is that flat vector."""
    prefix, period, groups = tf.stack_plan(cfg)
    layers = params["layers"]

    def at(tree, keys):
        for k in keys:
            tree = tree[k]
        return tree

    layout = layout_of(lm_steps.params_spec(cfg))
    pieces = []
    for path, shape in zip(layout.paths, layout.shapes):
        if path[0] == "stack":
            parts = [at(layers[prefix + g * period + path[1]], path[2:])
                     for g in range(groups)]
            want = shape[1:]
        elif path[0] == "prefix_layers":
            parts, want = [at(layers[path[1]], path[2:])], shape
        else:
            parts, want = [at(params, path)], shape
        if any(tuple(p.shape) != tuple(want) for p in parts):
            raise ValueError(f"serving leaves of {path} do not lay out as "
                             f"the reference's {shape}")
        pieces += parts
    return pieces


def _tp_hand_on(one_process, out: str) -> None:
    """Writes lm_train's run for the ranks into ``out``: its losses
    (json) and the params it ended on as the reference's flat vector
    (raw f32, one piece at a time off the card); then empties
    ``one_process``, so that the card holds the params no more."""
    cfg = get_config(LM_TRAIN_ARCH)
    with open(os.path.join(out, TP_ONE_PROCESS + ".json"), "w") as fh:
        json.dump(one_process["losses"], fh)
    with open(os.path.join(out, TP_ONE_PROCESS + ".f32"), "wb") as fh:
        for piece in reference_pieces(cfg, one_process["params"]):
            piece.detach().float().cpu().numpy().tofile(fh)
    one_process.clear()


def _tp_start(cfg, shards, m):
    """Model rank m's shard of the seed-0 params and the batch, each rank
    in its turn (one whole model on the card at a time)."""
    shard = batch = None
    for r in range(shards.model):
        if r == m:
            params, batch = _tp_lm_params(cfg, torch.Generator(
                device="cuda").manual_seed(0))
            flat = torch.cat([p.reshape(-1)
                              for p in reference_pieces(cfg, params)])
            shard = shards.scatter(flat, m)
            del flat
            del params
            gc.collect()
            torch.cuda.empty_cache()
        distributed.barrier(f"tp_start_{r}")
    return shard, batch


def _tp_step_line(ctx, out: str):
    """(a): LM_TRAIN_STEPS steps of make_train_step(remat="full") over the
    job's ranks as one model group, against lm_train's one-process run
    (its losses and this rank's shard of the params it ended on, from
    ``out``); the tensor-parallel collectives timed by a
    core/round._Collectives on the calling stream. Each leaf's error is
    taken against its max |w| and against how far one process's steps
    moved it (max |w_3 - w_0|)."""
    import torch.distributed as dist
    from repro_torch.core.round import _Collectives
    cfg = get_config(LM_TRAIN_ARCH)
    m = ctx.process_id
    step = lm_steps.make_train_step(cfg, lr=LM_TRAIN_LR, remat="full",
                                    model_group=dist.group.WORLD)
    shards = step.shards
    with open(os.path.join(out, TP_ONE_PROCESS + ".json")) as fh:
        want_losses = json.load(fh)
    full = np.memmap(os.path.join(out, TP_ONE_PROCESS + ".f32"),
                     dtype=np.float32, mode="c")
    if full.shape != (shards.layout.size,):
        raise AssertionError(f"tp_train: one process's params hold "
                             f"{full.shape}, the layout {shards.layout.size}")
    want = shards.scatter(torch.from_numpy(full), m)
    del full
    shard, batch = _tp_start(cfg, shards, m)
    # per leaf: max |w| and max |w_3 - w_0| of one process's run, then
    # the error; each rank's pieces reduced over the group
    nleaves = len(shards.layout.shapes)
    top, move, err = (torch.zeros(nleaves, device="cuda") for _ in range(3))
    for x in shards._blocks[m]:
        ref = want[x.at:x.at + x.size].to("cuda")
        top[x.leaf] = ref.abs().max()
        move[x.leaf] = (ref - shard[x.at:x.at + x.size]).abs().max()
    torch.cuda.reset_peak_memory_stats()
    timer = _Collectives(dist.group.WORLD)
    step.tp.timer = timer._run
    losses, seconds, coll = [], [], []
    for _ in range(LM_TRAIN_STEPS):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        shard, loss = step(shard, batch)
        losses.append(float(loss))          # a sync
        seconds.append(time.perf_counter() - tic)
        coll.append(_tally(timer.timings_ms()))
        timer.timings = []
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for x in shards._blocks[m]:
        ref = want[x.at:x.at + x.size].to("cuda")
        err[x.leaf] = (shard[x.at:x.at + x.size] - ref).abs().max()
    for t in (err, top, move):
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    rel = err / top.clamp(min=1e-30)
    of_move = err / move.clamp(min=1e-30)
    worst, worst_move = int(torch.argmax(rel)), int(torch.argmax(of_move))
    name = lambda i: "/".join(map(str, shards.layout.paths[i]))
    # the leaf classes a mix-up would hit (sharding/layout.tp_classes):
    # each class's least movement and worst error over it
    classes = {}
    for c in sorted(set(step.view.classes)):
        ids = [i for i, k in enumerate(step.view.classes) if k == c]
        classes[c] = {"leaves": len(ids),
                      "min_move_rel": min(float(move[i] / top[i])
                                          for i in ids),
                      "max_err_over_move": max(float(of_move[i])
                                               for i in ids)}
    n, n_m = shards.layout.size, shards.sizes[m]
    ntok = LM_TRAIN_B * LM_TRAIN_S
    return {"phase": "tp_train", "run": "a", "rank": ctx.process_id,
            "backend": ctx.backend, "model": shards.model, "arch": cfg.name,
            "layers": cfg.num_layers, "N": n, "N_m": n_m,
            "bytes_at_rest": 4 * n_m, "batch": LM_TRAIN_B,
            "seq_len": LM_TRAIN_S, "remat": "full", "losses": losses,
            "losses_one_process": want_losses,
            "loss_max_rel": max(abs(a - b) / abs(b)
                                for a, b in zip(losses, want_losses)),
            "leaf_max_rel": float(rel[worst]), "worst_leaf": name(worst),
            "leaf_max_err_over_move": float(of_move[worst_move]),
            "worst_leaf_of_move": name(worst_move),
            "its_move_rel": float(move[worst_move] / top[worst_move]),
            "classes": classes, "step_seconds": seconds,
            "tokens_per_s": ntok / statistics.median(seconds[1:]
                                                     or seconds),
            "peak_gib": peak, "tp_collectives_per_step": coll}


def _tp_fl_task(cfg):
    """Federated StarCoder2-3B at full width: TP_FL_CLIENTS clients of
    Zipf documents (Dirichlet(0.3) over topics), TP_FL_B sequences of
    TP_FL_S tokens a client a round, random weights from a seed."""
    from repro_torch.data.dirichlet import dirichlet_partition
    from repro_torch.data.synthetic import make_lm_dataset
    from repro_torch.ingest.sources import ListDataSource
    tokens, topics = make_lm_dataset(TP_FL_CLIENTS * 8, TP_FL_S + 1,
                                     cfg.vocab_size, seed=0)
    parts = dirichlet_partition(topics, TP_FL_CLIENTS, 0.3, seed=0,
                                min_size=1)

    def batch_fn(c, t):
        idx = parts[c]
        rng = np.random.RandomState(hash((c, t)) % (2 ** 31))
        sel = np.concatenate([idx[rng.permutation(len(idx))]] * TP_FL_B
                             )[:TP_FL_B]
        tk = tokens[sel]
        return [{"tokens": tk[:, :-1], "labels": tk[:, 1:]}]
    return ListDataSource(batch_fn)


def _tp_fl_line(ctx):
    """(c), four ranks or more: federated StarCoder2-3B at full width, K =
    TP_FL_COHORT on (1 x ranks), TP_FL_ROUNDS FedDPC rounds — the run
    the row split cannot hold (each model rank trains every row on its
    shard; at M = 4 the 2 KV heads are whole on every rank). The line
    is model_axis's (_ma_line)."""
    cfg = get_config(LM_TRAIN_ARCH)
    _ma_reset()
    params = tf.init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                        torch.float32)
    tr = FederatedTrainer(
        tf.LMLoss(cfg), params, TP_FL_CLIENTS, _tp_fl_task(cfg),
        ExecConfig(rounds=TP_FL_ROUNDS, clients_per_round=TP_FL_COHORT,
                   eval_every=10 ** 9, shard_clients=True,
                   shard_model=ctx.num_processes),
        algo=AlgoConfig(name="feddpc", eta_l=TP_FL_ETA, eta_g=TP_FL_ETA,
                        hyper=FedDPCHyper(lam=1.0)), device="cuda")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with tr:
        tr.run()
    line = _ma_line("f", tr, ctx, TP_FL_ROUNDS)
    line.update(phase="tp_train", run="c")
    return line


def _tp_worker(out: str) -> int:
    """One rank of the tp_train phase: (a) on every job, (c) on four ranks
    or more; writes its lines."""
    ctx = distributed.maybe_initialize()
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = [_tp_step_line(ctx, out)]
    gc.collect()
    torch.cuda.empty_cache()
    if ctx.num_processes >= 4:
        lines.append(_tp_fl_line(ctx))
    with open(os.path.join(out, f"rank{ctx.process_id}.json"), "w") as fh:
        json.dump(lines, fh)
    return 0


def phase_tp_train(one_process):
    """Tensor-parallel local training at full width (--tp-worker):
    (a) StarCoder2-3B, all 30 layers, f32, B = 2 x 1,024, LM_TRAIN_STEPS
    SGD steps of make_train_step(remat="full") over a model group of the
    job's ranks (tp_layout: 2 gloo ranks on one card), each rank stepping
    its shard, held against ``one_process`` (phase_lm_train's losses and
    the params its steps ended on, at the same seed): losses within
    TP_RTOL relative, every leaf within TP_RTOL of its max |w| and
    within TP_MOVE_FRAC of how far one process's steps moved it (a
    norm's gradient summed over the ranks, or a K/V gradient left
    partial, is off by about its whole movement). Each rank prints its
    peak memory, its bytes at rest, the step's seconds, its
    tensor-parallel collectives' count and ms a step, and each leaf
    class's least movement and worst error over it. With four cards or
    more (c): federated StarCoder2-3B at full width, K = 5 on (1 x 4)
    over NCCL, 2 FedDPC rounds: finite losses equal on every rank, one
    feddpc_dots and one feddpc_batched_epilogue a round, no
    param_all_gather or all_to_all."""
    cards = torch.cuda.device_count()
    ranks, backend = tp_layout(cards)
    tic = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as out:
        _tp_hand_on(one_process, out)
        hand_on_s = time.perf_counter() - tic
        gc.collect()
        torch.cuda.empty_cache()
        # what this process still holds on the card beside the ranks
        emit({"phase": "tp_train", "hand_on_seconds": hand_on_s,
              "parent_allocated_gib":
              torch.cuda.memory_allocated() / 2 ** 30,
              "parent_reserved_gib": torch.cuda.memory_reserved() / 2 ** 30})
        env = {}
        if backend == "nccl":
            env["NCCL_SOCKET_IFNAME"] = os.environ.get("NCCL_SOCKET_IFNAME",
                                                       "lo")
        distributed.spawn_local(
            [sys.executable, os.path.abspath(__file__), TP_WORKER, out],
            ranks, backend=backend,
            local_devices=1 if backend == "gloo" else None, env=env,
            timeout_s=600)
        lines = []
        for r in range(ranks):
            with open(os.path.join(out, f"rank{r}.json")) as fh:
                lines += json.load(fh)
    for line in lines:
        emit(line)
    for line in (x for x in lines if x["run"] == "a"):
        if not (line["loss_max_rel"] <= TP_RTOL
                and line["leaf_max_rel"] <= TP_RTOL
                and line["leaf_max_err_over_move"] <= TP_MOVE_FRAC):
            raise AssertionError(
                f"tp_train a rank {line['rank']}: losses {line['losses']} "
                f"against one process's {line['losses_one_process']}, "
                f"{line['worst_leaf']} {line['leaf_max_rel']} of its max "
                f"|w| (gate {TP_RTOL}), {line['worst_leaf_of_move']} "
                f"{line['leaf_max_err_over_move']} of its movement (gate "
                f"{TP_MOVE_FRAC})")
    for run in ("a", "c"):
        same = [x for x in lines if x["run"] == run]
        if any(x["losses"] != same[0]["losses"] for x in same):
            raise AssertionError(f"tp_train {run}: the ranks' losses differ")
    for line in (x for x in lines if x["run"] == "c"):
        if (line["launches"] != line["expected_launches"]
                or not all(math.isfinite(v) for v in line["losses"])
                or set(line["collective_ms_per_round"])
                & {"param_all_gather", "all_to_all"}
                or line["route"] != "tensor_parallel"):
            raise AssertionError(f"tp_train c rank {line['rank']}: {line}")
    emit({"phase": "tp_train", "backend": backend, "ranks": ranks,
          "cards": cards, "runs": sorted({x["run"] for x in lines}),
          "seconds": time.perf_counter() - tic})


def phase_lm_fl():
    """The reference example's full federated LM run on the card
    (examples/federated_llm_pretraining.py without --tiny: StarCoder2's
    family at ~101M params, 20 clients, 5 a round, Dirichlet(0.3) over
    2,000 Zipf documents of 257 tokens, batch 8, FedDPC with lam = 1 and
    eta = 0.05), LM_FL_ROUNDS rounds through FederatedTrainer on its
    defaults (the staging ring, async eval every round), the last one
    profiled. Each round must launch feddpc_dots and
    feddpc_batched_epilogue once and no serving kernel, and the losses
    and holdout NLLs must be the reference example's within
    LM_FL_RTOL."""
    task = llm_example.build(tiny=False, rounds=LM_FL_ROUNDS, device="cuda")
    algo = AlgoConfig(name="feddpc", eta_l=task.eta, eta_g=task.eta,
                      hyper=FedDPCHyper(lam=1.0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = FederatedTrainer(
        task.loss_fn, task.params, task.clients, task.batch_fn,
        ExecConfig(rounds=LM_FL_ROUNDS, clients_per_round=task.cohort,
                   eval_every=1), task.eval_fn, algo=algo, device="cuda")
    per_round = []
    with trainer:
        ops.reset_launches()               # this path starts here
        for mod in SERVE_KERNELS.values():
            mod.reset_launches()
        for t in range(LM_FL_ROUNDS):
            before = [fn.launches for fn in ops.KERNELS]
            if t == LM_FL_ROUNDS - 1:
                _, profile = profile_round(trainer, t, _lm_category)
            else:
                trainer.run_round(t)
            per_round.append({fn.__name__: fn.launches - b
                              for fn, b in zip(ops.KERNELS, before)
                              if fn.launches > b})
        trainer.finalize()
        hist = trainer.history
        n = trainer.layout.size
    serve_launches = _serve_launches()
    want = {name: 1 for name in SYNC_KERNELS}
    seconds = [r.seconds for r in hist]
    emit({"phase": "lm_fl", "model": "starcoder2 family, 12 layers, "
          "d_model 768", "params": n, "clients": task.clients,
          "cohort": task.cohort, "rounds": LM_FL_ROUNDS,
          "losses": [r.train_loss for r in hist],
          "holdout_nll": [None if r.test_accuracy is None
                          else -r.test_accuracy for r in hist],
          "round_seconds": seconds,
          "median_round_s_after_0": statistics.median(seconds[1:]),
          "launches_per_round": per_round,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "profile_idle_share": profile["device_idle_share"],
          "profile_by_category_ms": profile["by_category_ms"],
          **{f"{name}_launches": v for name, v in serve_launches.items()}})
    if any(r != want for r in per_round):
        raise AssertionError(f"lm_fl: launches a round {per_round}, "
                             f"expected {want}")
    if any(serve_launches.values()):
        raise AssertionError(f"lm_fl: serving kernels launched "
                             f"{serve_launches}")
    losses = [r.train_loss for r in hist]
    holdout = {t: -hist[t].test_accuracy for t in LM_FL_REFERENCE_NLL}
    for got, want in zip(losses + list(holdout.values()),
                         LM_FL_REFERENCE_LOSS
                         + list(LM_FL_REFERENCE_NLL.values())):
        if not abs(got - want) <= LM_FL_RTOL * abs(want):
            raise AssertionError(
                f"lm_fl: losses {losses} and holdout NLLs {holdout}, the "
                f"reference's {LM_FL_REFERENCE_LOSS} and "
                f"{LM_FL_REFERENCE_NLL}")
    del trainer, task
    torch.cuda.empty_cache()


def phase_quickstart():
    """The paper's quickstart at its own size (LeNet5, 15 rounds, 10 of 30
    clients, FedAvg then FedDPC) through repro_torch.examples.quickstart:
    FedDPC's rounds launch feddpc_dots and feddpc_batched_epilogue once
    each, FedAvg's none."""
    ops.reset_launches()                   # this path starts here
    hists = quickstart_example.main(rounds=QUICKSTART_ROUNDS,
                                    device="cuda")
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                if fn.launches}
    line = {"phase": "quickstart", "rounds": QUICKSTART_ROUNDS,
            "launches": launches}
    for name, hist in hists.items():
        secs = [r.seconds for r in hist[1:]]
        accs = [r.test_accuracy for r in hist if r.test_accuracy is not None]
        line[name] = {"final_loss": hist[-1].train_loss,
                      "best_accuracy": max(accs),
                      "median_round_s_after_0": statistics.median(secs)}
        if not all(math.isfinite(r.train_loss) for r in hist):
            raise AssertionError(f"quickstart {name}: non-finite losses")
    emit(line)
    want = {name: QUICKSTART_ROUNDS for name in SYNC_KERNELS}
    if launches != want:
        raise AssertionError(f"quickstart: launches {launches}, expected "
                             f"{want}")


def phase_lm_parity():
    """federated_llm_pretraining --tiny for 2 rounds on the card and on
    the CPU (the same init, data and cohorts): losses and holdout NLLs
    within LM_TINY_RTOL relative."""
    runs = {}
    for device in ("cuda", "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            runs[device] = llm_example.main(["--tiny", "--rounds", "2",
                                             "--device", device])
    pairs = [(getattr(a, k), getattr(b, k))
             for a, b in zip(runs["cuda"], runs["cpu"])
             for k in ("train_loss", "test_accuracy")
             if getattr(b, k) is not None]
    rel = max(abs(a - b) / abs(b) for a, b in pairs)
    emit({"phase": "parity", "run": "federated_llm_pretraining_tiny",
          "loss_cuda": [r.train_loss for r in runs["cuda"]],
          "loss_cpu": [r.train_loss for r in runs["cpu"]],
          "max_rel_diff": rel})
    if not rel <= LM_TINY_RTOL:
        raise AssertionError(f"tiny LM example: card vs CPU differ by "
                             f"{rel} relative > {LM_TINY_RTOL}")


# ---- the encoder-decoder, MoE, MLA and hybrid decoders (Whisper-base,
# DeepSeek-V2, Jamba-1.5, Kimi-K2) ----

WHISPER_ARCH = "whisper-base"
DEEPSEEK_ARCH = "deepseek-v2-236b"
JAMBA_ARCH = "jamba-1.5-large-398b"
KIMI_ARCH = "kimi-k2-1t-a32b"
# full width, depth cut to fit one card and the smoke's time: one dense
# and one MoE layer; Jamba's 1:7 attention interleave cut to 1:1 (8
# full-width layers are 45e9 parameters); Kimi-K2 at two layers is 39.9 GB
# in bf16, so it runs bf16 only
MOE_SERVE = (
    (DEEPSEEK_ARCH, {"num_layers": 2}, (torch.float32, torch.bfloat16)),
    (JAMBA_ARCH, {"num_layers": 2, "attn_every": 2},
     (torch.float32, torch.bfloat16)),
    (KIMI_ARCH, {"num_layers": 2}, (torch.bfloat16,)),
)
WHISPER_TRAIN_B, WHISPER_TRAIN_T, WHISPER_TRAIN_STEPS = 8, 448, 3
WHISPER_TRAIN_LR = 0.01
MOE_PARITY_RTOL = 1e-4        # card vs CPU, relative to max |logit| or |loss|
MOE_CLI_ARGS = ["--model", DEEPSEEK_ARCH, "--seq-len", "33", "--rounds", "2",
                "--clients", "4", "--participation", "0.5", "--batch-size",
                "4", "--eval-every", "1"]


def _encdec_teacher_forced(cfg, params, frames, forced, impl):
    """Encode ``frames``, then decode from BOS with one cached step per
    column of ``forced`` (the same tokens whatever the model predicts):
    each step's logits, stacked (1 + steps, B, V) in f32."""
    b, steps = forced.shape
    states = encdec.init_decoder_states(cfg, b, steps + 1,
                                        params["embed"].dtype, frames.device)
    with torch.inference_mode():
        enc_out = encdec.encode(cfg, params, frames, impl)
        tok = torch.zeros((b, 1), dtype=torch.int64, device=frames.device)
        out = []
        for i in range(steps + 1):
            pos = torch.full((b, 1), i, dtype=torch.int32,
                             device=frames.device)
            logits, states = encdec.decode(cfg, params, tok, enc_out, pos,
                                           states=states, attn_impl=impl)
            out.append(logits[:, -1].float())
            if i < steps:
                tok = forced[:, i:i + 1]
    return torch.stack(out)


def profile_serve_encdec(cfg, params, frames):
    """The encode and one decode step under torch.profiler: the encode
    must launch one flash kernel an encoder layer, the decode step two a
    decoder layer (self- and cross-attention), on the host and on the
    device (a step whose device count is off is profiled once more)."""
    b = frames.shape[0]
    dtype = str(params["embed"].dtype)[6:]
    states = encdec.init_decoder_states(cfg, b, 2, params["embed"].dtype,
                                        "cuda")
    read = _check_profiled_step(
        cfg.name, "prefill",
        lambda retry: _profiled(lambda: encdec.encode(cfg, params, frames),
                                retry),
        cfg.encoder_layers, None)
    _emit_profile(cfg.name, dtype, "prefill", read)
    enc_out = read["result"]
    tok = torch.zeros((b, 1), dtype=torch.int64, device="cuda")
    pos = torch.zeros((b, 1), dtype=torch.int32, device="cuda")

    def step():
        logits, _ = encdec.decode(cfg, params, tok, enc_out, pos,
                                  states=states)
        return logits
    read = _check_profiled_step(cfg.name, "decode",
                                lambda retry: _profiled(step, retry),
                                2 * cfg.num_layers, None)
    _emit_profile(cfg.name, dtype, "decode", read)


def _encdec_train_flops(cfg, b, t_enc, t_dec) -> float:
    """FLOPs of one training step (forward + backward = 3 forwards) of
    the encoder-decoder on (b, t_enc) frames and (b, t_dec) tokens: the
    linears at 2 FLOPs a weight a token, attention at 4·d a visible
    (query, key) pair — bidirectional in the encoder and across, causal
    in the decoder's self-attention."""
    d, dff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    mlp = 2 * d * dff
    enc = cfg.encoder_layers * (2 * b * t_enc * (4 * d * d + mlp)
                                + 4 * d * b * t_enc * t_enc)
    causal_pairs = b * t_dec * (t_dec + 1) // 2
    dec = cfg.num_layers * (
        2 * b * t_dec * (4 * d * d + 2 * d * d + mlp)   # self, cross q/o
        + 2 * b * t_enc * 2 * d * d                     # cross k/v
        + 4 * d * causal_pairs + 4 * d * b * t_dec * t_enc)
    head = 2 * b * t_dec * d * v
    return 3.0 * (enc + dec + head)


def phase_whisper_train():
    """Whisper-base's training step at full width and depth:
    launch/steps.make_train_step (encdec_loss_fn, plain autograd, SGD at
    WHISPER_TRAIN_LR) on B = 8 clips of 1,500 random frames and 448
    target tokens, 3 steps (random weights from seed 0). The loss must be
    finite and fall, and the training route (plain attention: the kernel
    has no backward) must launch no serving kernel. Seconds a step, peak
    memory and the FLOP bound at the f32 peak."""
    cfg = get_config(WHISPER_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = encdec.init_encdec(cfg, gen, torch.float32)
    n_params = sum(t.numel() for t in tree_leaves(params))
    b, t = WHISPER_TRAIN_B, WHISPER_TRAIN_T
    frames = torch.randn((b, cfg.encoder_seq_len, cfg.d_model),
                         generator=gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (b, t + 1), generator=gen,
                           device="cuda")
    batch = {"frames": frames, "tokens": tokens[:, :-1],
             "labels": tokens[:, 1:]}
    step = lm_steps.make_train_step(cfg, lr=WHISPER_TRAIN_LR)
    _reset_serve_launches()                # this path starts here
    losses, seconds = [], []
    for _ in range(WHISPER_TRAIN_STEPS):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        params, loss = step(params, batch)
        losses.append(float(loss))         # a sync
        seconds.append(time.perf_counter() - tic)
    launches = _serve_launches()
    flops = _encdec_train_flops(cfg, b, cfg.encoder_seq_len, t)
    bound, _ = bound_ms(0, flops)
    median = statistics.median(seconds[1:])
    emit({"phase": "whisper_train", "arch": cfg.name,
          "encoder_layers": cfg.encoder_layers, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "params": n_params, "dtype": "float32",
          "batch": b, "frames": cfg.encoder_seq_len, "target_len": t,
          "lr": WHISPER_TRAIN_LR, "losses": losses, "step_seconds": seconds,
          "median_step_s": median, "bound_s": bound / 1e3,
          "bound_flop": flops, "pct_of_bound": 100.0 * bound / 1e3 / median,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          **{f"{name}_launches": n for name, n in launches.items()}})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"whisper_train: non-finite losses {losses}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"whisper_train: the loss did not fall: "
                             f"{losses}")
    if any(launches.values()):
        raise AssertionError(f"whisper_train: the training route launched "
                             f"serving kernels {launches}")
    del params, step, batch
    torch.cuda.empty_cache()


def _rel(card, cpu) -> float:
    return float((card.cpu() - cpu).abs().max()) / max(
        float(cpu.abs().max()), 1e-30)


def _routing(cfg, router, x):
    """(expert ids (1, T, k), ties) of ``x`` (B, S, D) through
    ``router``: a tie is a token whose k-th and (k + 1)-th probabilities
    are equal (top-k then takes the lower expert, as jax.lax.top_k)."""
    logits = linear(router, x.reshape(1, -1, x.shape[-1]).float())
    _, idx, _ = moe._route(cfg, logits)
    if cfg.top_k >= cfg.num_experts:
        return idx, 0
    top = torch.topk(torch.softmax(logits, -1), cfg.top_k + 1, dim=-1).values
    return idx, int((top[..., -1] == top[..., -2]).sum())


def _moe_atomics(arch, dtype):
    """One MoE layer of ``arch`` at full width in ``dtype`` (random
    weights), B·S = SERVE_B x SERVE_PROMPT tokens, run twice on the same
    input: the output elements that differ bit for bit between the two
    calls (the combine's scatter-add sums a token's top-k contributions
    by atomics, in no fixed order), and the routing ties."""
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    p = moe.init_moe(gen, cfg, dtype)
    x = torch.randn((SERVE_B, SERVE_PROMPT, cfg.d_model), generator=gen,
                    device="cuda").to(dtype)
    with torch.inference_mode():
        a, _ = moe.moe_forward(cfg, p, x)
        b, _ = moe.moe_forward(cfg, p, x)
        _, ties = _routing(cfg, p["router"], x)
    out = {"arch": arch, "dtype": str(dtype)[6:],
           "tokens": SERVE_B * SERVE_PROMPT,
           "top_k": cfg.top_k, "experts": cfg.num_experts,
           "elements_differing_between_calls": int((a != b).sum()),
           "max_abs_diff_between_calls": float((a - b).abs().max()),
           "elements": a.numel(), "routing_ties": ties}
    del p, x, a, b
    torch.cuda.empty_cache()
    return out


def phase_moe_parity():
    """Card against CPU at SMOKE size, f32, the same params and inputs:
    DeepSeek-V2, Jamba and Kimi-K2 (prefill plus SMOKE_STEPS
    teacher-forced decode steps, logits within MOE_PARITY_RTOL of
    max|logit|; the first MoE layer's expert assignments equal, its
    output within MOE_PARITY_RTOL), Whisper-base's encode and cached
    decode; the training CLI with --model deepseek-v2-236b (MLA + MoE
    through the FL trainer's vmap(grad)) on both, round losses within
    MOE_PARITY_RTOL relative. Then the atomics and ties of a full-width
    MoE layer (``_moe_atomics``) of DeepSeek-V2 (top-6, f32) and Kimi-K2
    (top-8, bf16: its 384 experts are 67.6 GB in f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False      # the reference's f32
    failures = []
    for arch in (DEEPSEEK_ARCH, JAMBA_ARCH, KIMI_ARCH):
        cfg = get_config(arch, smoke=True)
        gen = torch.Generator().manual_seed(0)
        params = tf.init_lm(cfg, gen, torch.float32)
        prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen)
        forced = torch.randint(0, cfg.vocab_size, (4, SMOKE_STEPS),
                               generator=gen)
        card_params = tree_map(lambda t: t.cuda(), params)
        card = _teacher_forced(cfg, card_params, prompts.cuda(),
                               forced.cuda(), "auto")
        cpu = _teacher_forced(cfg, params, prompts, forced, "auto")
        layer = next(i for i, (_, is_moe) in enumerate(tf.layer_specs(cfg))
                     if is_moe)
        mlp, card_mlp = params["layers"][layer]["mlp"], \
            card_params["layers"][layer]["mlp"]
        x = torch.randn((4, 64, cfg.d_model), generator=gen)
        idx_cpu, ties = _routing(cfg, mlp["router"], x)
        idx_card, _ = _routing(cfg, card_mlp["router"], x.cuda())
        with torch.inference_mode():
            y_cpu, aux_cpu = moe.moe_forward(cfg, mlp, x)
            y_card, aux_card = moe.moe_forward(cfg, card_mlp, x.cuda())
        line = {"phase": "moe_parity", "arch": arch,
                "steps": 1 + SMOKE_STEPS, "logits_rel_diff": _rel(card, cpu),
                "moe_layer": layer,
                "assignments_equal": bool(torch.equal(idx_card.cpu(),
                                                      idx_cpu)),
                "routing_ties": ties, "moe_out_rel_diff": _rel(y_card, y_cpu),
                "aux_abs_diff": abs(float(aux_card) - float(aux_cpu))}
        emit(line)
        if not (line["logits_rel_diff"] <= MOE_PARITY_RTOL
                and line["moe_out_rel_diff"] <= MOE_PARITY_RTOL
                and line["assignments_equal"]):
            failures.append(f"{arch}: {line}")
    cfg = get_config(WHISPER_ARCH, smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = encdec.init_encdec(cfg, gen, torch.float32)
    frames = torch.randn((4, cfg.encoder_seq_len, cfg.d_model), generator=gen)
    forced = torch.randint(0, cfg.vocab_size, (4, SMOKE_STEPS),
                           generator=gen)
    card = _encdec_teacher_forced(cfg, tree_map(lambda t: t.cuda(), params),
                                  frames.cuda(), forced.cuda(), "auto")
    cpu = _encdec_teacher_forced(cfg, params, frames, forced, "auto")
    line = {"phase": "moe_parity", "arch": WHISPER_ARCH,
            "steps": 1 + SMOKE_STEPS, "logits_rel_diff": _rel(card, cpu)}
    emit(line)
    if not line["logits_rel_diff"] <= MOE_PARITY_RTOL:
        failures.append(f"{WHISPER_ARCH}: {line}")
    hist = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_cli_") as root:
        for device in ("cuda", "cpu"):
            path = os.path.join(root, f"{device}.json")
            with contextlib.redirect_stdout(io.StringIO()):
                if train_cli.main(MOE_CLI_ARGS + ["--device", device,
                                                  "--out", path]) != 0:
                    raise AssertionError(f"train CLI {DEEPSEEK_ARCH} on "
                                         f"{device} failed")
            with open(path) as fh:
                hist[device] = [r["train_loss"] for r in json.load(fh)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(hist["cuda"], hist["cpu"]))
    emit({"phase": "moe_parity", "run": "train_cli", "args": MOE_CLI_ARGS,
          "loss_cuda": hist["cuda"], "loss_cpu": hist["cpu"],
          "max_rel_diff": rel})
    if not rel <= MOE_PARITY_RTOL:
        failures.append(f"train CLI {DEEPSEEK_ARCH}: {rel}")
    for arch, dtype in ((DEEPSEEK_ARCH, torch.float32),
                        (KIMI_ARCH, torch.bfloat16)):
        emit({"phase": "moe_atomics", **_moe_atomics(arch, dtype)})
    if failures:
        raise AssertionError("moe_parity: " + "; ".join(failures))


# ---------------- moe_parallel: the MoE layer on the mesh ----------------

MP_WORKER = "--moe-parallel-worker"
MP_SEED = 0
MP_B, MP_S = 2, 1024          # (a): DeepSeek-V2's layer on B x S tokens
MP_EP_CF = 8.0                # EP against GShard: the reference's setting
MP_RTOL = 1e-4                # (a): a rank against one process, of max |.|
MP_FED_ROUNDS, MP_FED_COHORT, MP_FED_ETA = 2, 4, 0.05
MP_FED_RTOL = 1e-4            # (c): card against the CPU, of max |.|
MP_KIMI_CUT = {"num_layers": 2}          # (b): kimi_serve's depth cut
MP_KIMI_STEPS, MP_KIMI_LR = 3, 0.01
MP_FLIP_FRAC = 1e-3           # (b): expert assignments that may differ
MP_LOSS_RTOL = 1e-4           # (b): TP against EP losses
MP_MOVE_FRAC = 1e-2           # (b): a leaf's TP-EP gap against its movement


def _mp_layer_layout(cfg):
    """The flat layout of an MoE layer's tree {"mlp": init_moe(...)}: its
    paths a decoder layer's, which the sharding rules read."""
    return layout_of({"mlp": moe.init_moe("meta", cfg, torch.float32)})


def _mp_routing(cfg, router, x, groups=1):
    """Expert ids (G, T/G, k) of ``x`` through ``router``."""
    logits = linear(router, x.reshape(groups, -1, x.shape[-1]).float())
    return moe._route(cfg, logits)[1]


def _mp_one_process(cfg, shards, r, groups, tag):
    """One process's layer (moe_forward, ``groups`` token groups): forward
    and backward of sum(out * proj) + aux on the seeded params and input,
    run in rank r's turn (one whole layer on the card at a time, its
    leaves and their gradients cut to the rank's pieces a leaf at a
    time: no flat copy of either). Returns rank r's shard of the params
    and of their gradient, and the output, aux, expert ids, input,
    projection and seconds of the run."""
    res = None
    for turn in range(shards.ranks):
        if turn == r:
            gen = torch.Generator(device="cuda").manual_seed(MP_SEED)
            p = {"mlp": moe.init_moe(gen, cfg, torch.float32)}
            x = torch.randn((MP_B, MP_S, cfg.d_model), generator=gen,
                            device="cuda")
            proj = torch.randn(x.shape, generator=gen, device="cuda")
            leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
            torch.cuda.synchronize()
            tic = time.perf_counter()
            out, aux = moe.moe_forward(cfg, p["mlp"], x, groups=groups)
            grads = list(torch.autograd.grad((out * proj).sum() + aux,
                                             leaves))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - tic
            with torch.no_grad():
                idx = _mp_routing(cfg, p["mlp"]["router"], x, groups)
            held = [i for i, _ in shards.held(r)]
            cut = lambda ts: torch.cat([shards.leaf_piece(r, i, ts[i])
                                        for i in held])
            # one process's gradient waits on the host while the rank's
            # own run holds the card with the other rank's
            res = {"grad": cut(grads).cpu(), "out": out.detach(),
                   "aux": float(aux), "idx": idx, "x": x, "proj": proj,
                   "seconds": seconds}
            del grads, out
            res["shard"] = cut([t.detach() for t in leaves])
            del p, leaves
            gc.collect()
            torch.cuda.empty_cache()
        distributed.barrier(f"mp_{tag}_{turn}")
    return res


def _mp_leaf_errors(shards, r, got, want):
    """Per leaf of shard r: max |got - want| over max |want| (0 for a
    leaf it holds none of), reduced with MAX over the job."""
    import torch.distributed as dist
    err = torch.zeros(len(shards.layout.shapes), device="cuda")
    at = 0
    for i, shape in shards.held(r):
        n = int(np.prod(shape))
        g, w = got[at:at + n], want[at:at + n]
        err[i] = (g - w).abs().max() / w.abs().max().clamp(min=1e-30)
        at += n
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return err


def _mp_layer_line(run, ctx, cfg, shards, r, ref, got, timer, seconds,
                   ids_equal):
    """(a)'s line of one rank and form: the gates' numbers, what the rank
    holds at rest, its peak, seconds and collectives."""
    out, aux, grad = got
    err = _mp_leaf_errors(shards, r, grad, ref["grad"].cuda())
    worst = int(torch.argmax(err))
    name = lambda i: "/".join(map(str, shards.layout.paths[i]))
    experts = [i for i, _ in shards.held(r)
               if re.search(r"mlp/(gate|up|down)$", name(i))]
    held = dict(shards.held(r))
    return {"phase": "moe_parallel", "run": run, "rank": r,
            "backend": ctx.backend, "arch": cfg.name,
            "tokens": MP_B * MP_S, "capacity_factor": cfg.capacity_factor,
            "experts": cfg.num_experts, "top_k": cfg.top_k,
            "bytes_at_rest": 4 * shards.sizes[r],
            "expert_bytes_at_rest": 4 * sum(int(np.prod(held[i]))
                                            for i in experts),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "seconds": seconds, "one_process_seconds": ref["seconds"],
            "collectives": _tally(timer.timings_ms()),
            "expert_ids_equal": ids_equal,
            "out_rel": float((out - ref["out"]).abs().max()
                             / ref["out"].abs().max()),
            "aux_rel": abs(float(aux) - ref["aux"]) / abs(ref["aux"]),
            "grad_rel": float(err[worst]), "worst_leaf": name(worst)}


def _mp_tp_line(ctx):
    """(a) TP: DeepSeek-V2's MoE layer at full width tensor-parallel over
    the job's 2 ranks (1 x 2) at its capacity factor (1.25), against one
    process's layer."""
    import torch.distributed as dist
    from repro_torch.core.round import _Collectives
    from repro_torch.sharding.layout import ShardLayout, TPView
    from repro_torch.sharding.tensor_parallel import TPContext
    cfg = get_config(DEEPSEEK_ARCH)
    r = ctx.process_id
    shards = ShardLayout.from_sizes(_mp_layer_layout(cfg),
                                    {"clients": 1, "model": 2})
    ref = _mp_one_process(cfg, shards, r, 1, "tp")
    tp = TPContext.of(dist.group.WORLD)
    timer = _Collectives(dist.group.WORLD)
    tp.timer = timer._run
    view = TPView(shards, r, cfg.resolved_head_dim, tp)
    torch.cuda.reset_peak_memory_stats()
    shard = ref["shard"].requires_grad_(True)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    tree = view.unflatten(shard)["mlp"]
    out, aux = moe.moe_forward(cfg, tree, ref["x"], tp=tp)
    (grad,) = torch.autograd.grad((out * ref["proj"]).sum() + aux, shard)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - tic
    with torch.no_grad():
        idx = _mp_routing(cfg, tree["router"], ref["x"])
    both = [torch.empty_like(idx) for _ in range(2)]
    dist.all_gather(both, idx)
    same = all(torch.equal(b, ref["idx"]) for b in both)
    line = _mp_layer_line("a_tp", ctx, cfg, shards, r, ref,
                          (out.detach(), aux, grad), timer, seconds, same)
    line["mesh"] = [1, 2]
    return line


def _mp_ep_line(ctx):
    """(a) EP: the same layer expert-parallel on (2 x 1), each rank on its
    row of the batch and its 80 experts, at capacity factor 8, against
    one process's layer at 8 in two token groups (a rank's tokens each)."""
    import torch.distributed as dist
    from repro_torch.core.round import _Collectives
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe_ep
    from repro_torch.sharding.layout import ShardLayout, TPView
    cfg = get_config(DEEPSEEK_ARCH).with_(capacity_factor=MP_EP_CF)
    r = ctx.process_id
    mesh = make_debug_mesh(2, 1)
    shards = ShardLayout.for_experts(_mp_layer_layout(cfg), 2, 1)
    ref = _mp_one_process(cfg, shards, r, 2, "ep")
    ep, _ = moe_ep.contexts(mesh)
    timer = _Collectives(ep.group)
    ep.timer = timer._run
    view = TPView(shards, 0, cfg.resolved_head_dim, None, rank=r)
    torch.cuda.reset_peak_memory_stats()
    shard = ref["shard"].requires_grad_(True)
    x, proj = ref["x"][r:r + 1], ref["proj"][r:r + 1]
    torch.cuda.synchronize()
    tic = time.perf_counter()
    tree = view.unflatten(shard)["mlp"]
    out, aux = moe_ep.moe_forward_ep(cfg, tree, x, mesh=mesh, ep=ep)
    (grad,) = torch.autograd.grad((out * proj).sum() + aux, shard)
    # the leaves whole over the data axis: their gradient summed over it
    at = 0
    for i, shape in shards.held(r):
        n = int(np.prod(shape))
        if "data" not in shards.specs[i]:
            g = grad[at:at + n]
            ep._timed("data_grad_sum", g,
                      lambda g=g: dist.all_reduce(g, group=ep.group))
        at += n
    torch.cuda.synchronize()
    seconds = time.perf_counter() - tic
    with torch.no_grad():
        idx = _mp_routing(cfg, tree["router"], x)
    ref["out"] = ref["out"][r:r + 1]
    line = _mp_layer_line("a_ep", ctx, cfg, shards, r, ref,
                          (out.detach(), aux, grad), timer, seconds,
                          bool(torch.equal(idx[0], ref["idx"][r])))
    line["mesh"] = [2, 1]
    return line


def _mp_fed_trainer(device, sharded):
    """The CPU test's federated run of Kimi-K2 SMOKE (the training CLI's
    LM task: 6 clients, 4 a round, FedDPC, MP_FED_ROUNDS rounds), on the
    tensor-parallel route over (1 x 2) when ``sharded``."""
    from types import SimpleNamespace
    kw = {"shard_clients": True, "shard_model": 2} if sharded else {}
    cfg = ExecConfig(rounds=MP_FED_ROUNDS, clients_per_round=MP_FED_COHORT,
                     seed=0, eval_every=10 ** 9, batch_size=2, **kw)
    args = SimpleNamespace(model=KIMI_ARCH, clients=6, seq_len=17, seed=0,
                           alpha=0.5, batch_size=2)
    params, loss_fn, source, _ = train_cli.build_lm_task(args, cfg, device)
    return FederatedTrainer(
        loss_fn, params, args.clients, source, cfg,
        algo=AlgoConfig(name="feddpc", eta_l=MP_FED_ETA, eta_g=MP_FED_ETA),
        device=device)


def _mp_fed_line(ctx, out):
    """(c): the federated run on the card over the job's 2 ranks; rank 0
    writes the params it ends on for the CPU comparison."""
    _ma_reset()
    tr = _mp_fed_trainer("cuda", True)
    with tr:
        tr.run()
    params = tr.full_params()
    if ctx.process_id == 0:
        np.save(os.path.join(out, "c_params.npy"), params.cpu().numpy())
    line = _ma_line("fed", tr, ctx, MP_FED_ROUNDS)
    line.update(phase="moe_parallel", run="c")
    return line


def _mp_leaf_init(layout, i):
    """Leaf i of the reference's tree drawn alone on the card, from a seed
    of its own (a shard is drawn a leaf at a time: the whole model does
    not fit a card): norms 1, the embedding N(0, 0.02²), every other
    leaf N(0, 1/fan_in) — init_lm's distributions."""
    path = "/".join(map(str, layout.paths[i]))
    shape = tuple(layout.shapes[i])
    if path.endswith("scale"):
        return torch.ones(shape, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(MP_SEED * 1000 + i)
    x = torch.randn(shape, generator=gen, device="cuda")
    return x.mul_(0.02 if path.endswith("embed")
                  else 1.0 / math.sqrt(shape[-2]))


def _mp_held_at(shards, r):
    """{leaf: (start, size)} of shard r's pieces."""
    out, at = {}, 0
    for i, shape in shards.held(r):
        n = int(np.prod(shape))
        out[i] = (at, n)
        at += n
    return out


def _mp_kimi_run(ctx, form, out):
    """(b), one form: MP_KIMI_STEPS SGD steps of make_train_step(remat=
    "full") on Kimi-K2 at full width and 2 layers, f32, at capacity
    factor 8: "tp" over the job's 4 ranks as one model group (1 x 4),
    "ep" on make_debug_mesh(2, 2). Returns the rank's line, its shard
    after the first step on the host and its layout; each rank writes
    the MoE layer's expert ids of each step's forward."""
    import torch.distributed as dist
    from repro_torch.core.round import _Collectives
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe_ep
    cfg = get_config(KIMI_ARCH).with_(capacity_factor=MP_EP_CF,
                                      **MP_KIMI_CUT)
    r = ctx.process_id
    if form == "tp":
        # the aux of two token groups, as the (2 x 2) mesh's two expert
        # shards take it
        step = lm_steps.make_train_step(cfg, lr=MP_KIMI_LR, remat="full",
                                        moe_groups=2,
                                        model_group=dist.group.WORLD)
    else:
        step = lm_steps.make_train_step(cfg, lr=MP_KIMI_LR, remat="full",
                                        moe_impl="ep",
                                        moe_mesh=make_debug_mesh(2, 2))
    shards = step.shards
    layout = shards.layout
    shard = torch.empty(shards.sizes[r], device="cuda")
    for i, (a, n) in _mp_held_at(shards, r).items():
        leaf = _mp_leaf_init(layout, i)
        shard[a:a + n] = shards.leaf_piece(r, i, leaf)
        del leaf
    gen = torch.Generator(device="cuda").manual_seed(MP_SEED)
    tokens = torch.randint(0, cfg.vocab_size, (LM_TRAIN_B, LM_TRAIN_S + 1),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    timer = _Collectives(dist.group.WORLD)
    for c in (step.tp, getattr(step, "ep", None)):
        if c is not None:
            c.timer = timer._run
    ids = []
    route = moe._route

    def recording(cfg_, logits):
        g, i, a = route(cfg_, logits)
        if len(ids) == len(losses):     # the step's forward, not remat's
            ids.append(i.detach().cpu())
        return g, i, a
    moe._route = moe_ep._route = recording
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, coll = [], [], []
    try:
        for _ in range(MP_KIMI_STEPS):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            shard, loss = step(shard, batch)
            losses.append(float(loss))
            seconds.append(time.perf_counter() - tic)
            coll.append(_tally(timer.timings_ms()))
            timer.timings = []
            if len(losses) == 1:
                # the comparison's point: both forms from one start, one
                # step on (later steps part where their routes part)
                host = shard.to("cpu", copy=True)
    finally:
        moe._route = moe_ep._route = route
    coords = getattr(step, "coords", (0, r))
    if coords[1] == 0:
        torch.save(torch.stack(ids), os.path.join(
            out, f"b_{form}_ids_d{coords[0]}.pt"))
    line = {"phase": "moe_parallel", "run": f"b_{form}", "rank": r,
            "backend": ctx.backend, "arch": cfg.name,
            "layers": cfg.num_layers, "mesh": [1, 4] if form == "tp"
            else [2, 2], "N": layout.size, "N_r": shards.sizes[r],
            "bytes_at_rest": 4 * shards.sizes[r], "batch": LM_TRAIN_B,
            "seq_len": LM_TRAIN_S, "capacity_factor": MP_EP_CF,
            "experts": cfg.num_experts, "top_k": cfg.top_k,
            "losses": losses, "step_seconds": seconds,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "collectives_per_step": coll}
    del shard, step
    gc.collect()
    torch.cuda.empty_cache()
    return line, host, shards


_MP_STACKS = (r"mlp/gate$", r"mlp/up$", r"mlp/down$")


def _mp_kimi_compare(r, tp, ep, experts):
    """Every leaf of the two forms' params after the first step,
    elementwise on rank r's
    EP piece: the TP pieces all-gathered a leaf at a time and laid out
    whole, the EP piece cut from it, against how far the steps moved it
    from the seeded start. Returns, per leaf, (2, 2, L): the max and the
    sum of squares of the gap and of the movement; and the same per
    expert, (2, 2, 3, E), over its slice of each of the three expert
    stacks. Reduced over the job (a leaf the data rows both hold counts
    twice in both terms of a ratio)."""
    import torch.distributed as dist
    (tp_host, tp_shards), (ep_host, ep_shards) = tp, ep
    layout = tp_shards.layout
    nleaves = len(layout.shapes)
    per_leaf = torch.zeros((2, 2, nleaves), device="cuda")
    per_expert = torch.zeros((2, 2, len(_MP_STACKS), experts),
                             device="cuda")
    tp_at, ep_at = _mp_held_at(tp_shards, r), _mp_held_at(ep_shards, r)
    held = dict(ep_shards.held(r))
    world = tp_shards.ranks
    d = r // ep_shards.model
    for i in range(nleaves):
        sizes = [sum(b.size for b in tp_shards._leaf_blocks(q, i))
                 for q in range(world)]
        a, n = ep_at.get(i, (0, 0))
        start = (ep_shards.leaf_piece(r, i, _mp_leaf_init(layout, i))
                 if n else None)
        mine = torch.zeros(max(sizes), device="cuda")
        if i in tp_at:
            ta, tn = tp_at[i]
            mine[:tn] = tp_host[ta:ta + tn].cuda()
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine)
        del mine
        if n:
            whole = tp_shards.leaf_from_pieces(i, parts)
            del parts
            want = ep_shards.leaf_piece(r, i, whole)
            del whole
            got = ep_host[a:a + n].cuda()
            path = "/".join(map(str, layout.paths[i]))
            k = next((k for k, pat in enumerate(_MP_STACKS)
                      if re.search(pat, path)), None)
            for j, g in enumerate(((got - want).abs(),
                                   (want - start).abs())):
                per_leaf[0, j, i] = g.max()
                per_leaf[1, j, i] = g.square().sum()
                if k is None:
                    continue
                # the expert dim of a stack (..., E, D, F): -3
                v = g.view(held[i]).movedim(-3, 0)
                v = v.reshape(v.shape[0], -1)
                lo = d * v.shape[0]
                seg = per_expert[0, j, k, lo:lo + v.shape[0]]
                torch.maximum(seg, v.amax(1), out=seg)
                per_expert[1, j, k, lo:lo + v.shape[0]] += v.square().sum(1)
            del got, want, start
        else:
            del parts
        torch.cuda.empty_cache()
    for t, op in ((per_leaf[0], dist.ReduceOp.MAX),
                  (per_leaf[1], dist.ReduceOp.SUM),
                  (per_expert[0], dist.ReduceOp.MAX),
                  (per_expert[1], dist.ReduceOp.SUM)):
        part = t.contiguous()
        dist.all_reduce(part, op=op)
        t.copy_(part)
    return per_leaf, per_expert


def _mp_kept(ids, buckets, cap):
    """Whether each assignment of ``ids`` (T, k) keeps its slot when the
    tokens are cut into ``buckets`` equal runs and each (run, expert)
    holds ``cap`` slots in token order (the GShard groups of the TP
    form; the EP form's experts, which take their assignments source by
    source in token order, are one run at its per-expert capacity)."""
    t, k = ids.shape
    run = (torch.arange(t) // (t // buckets))[:, None].expand(t, k)
    key = (run * (int(ids.max()) + 1) + ids).reshape(-1)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(key)
    rank[order] = torch.arange(key.numel()) - starts[key[order]]
    return (rank < cap).reshape(t, k)


def _mp_flips(out, cfg):
    """The EP form's expert ids against the TP form's, step by step: an
    assignment flips where it is not among the other form's top-k of
    its token. A token is perturbed where one flips, or where one is
    dropped (past its capacity) in one form and kept in the other.
    Returns (assignments, flips a step, drops a step in each form, the
    experts that served a perturbed token in either form)."""
    from repro_torch.models import moe_ep
    tp = torch.load(os.path.join(out, "b_tp_ids_d0.pt"))
    ep = torch.cat([torch.load(os.path.join(out, f"b_ep_ids_d{d}.pt"))
                    for d in range(2)], dim=2)
    tp, ep = (t.reshape(t.shape[0], -1, t.shape[-1]) for t in (tp, ep))
    steps, tokens, k = tp.shape
    gone = (tp.unsqueeze(-1) != ep.unsqueeze(-2)).all(-1)   # tp's not in ep
    tp_cap = moe.capacity_per_group(cfg, tokens // 2)
    send = moe_ep._send_capacity(cfg, tokens // 2, 2)
    ep_cap = moe.round_capacity(2 * send // (cfg.num_experts // 2))
    drops, perturbed = [], gone.any(-1)
    for s in range(steps):
        kt, ke = _mp_kept(tp[s], 2, tp_cap), _mp_kept(ep[s], 1, ep_cap)
        drops.append([int((~kt).sum()), int((~ke).sum())])
        # a kept-in-one, dropped-in-the-other assignment of the same id
        same = tp[s].unsqueeze(-1) == ep[s].unsqueeze(-2)
        differ = same & (kt.unsqueeze(-1) != ke.unsqueeze(-2))
        perturbed[s] |= differ.any(-1).any(-1)
    touched = set(tp[perturbed].reshape(-1).tolist()) \
        | set(ep[perturbed].reshape(-1).tolist())
    return (int(tp.numel()), gone.sum(dim=(1, 2)).tolist(), drops,
            sorted(touched))


def _mp_b_gates(lines, flips):
    """(b)'s line and gates. Over the MP_KIMI_STEPS steps: flips at most
    MP_FLIP_FRAC of the assignments, losses within MP_LOSS_RTOL. After
    the first step, where both forms start from the same params and
    route alike (no flip, no drop: a gate of its own), every leaf within
    MP_MOVE_FRAC of its movement, max |w_EP - w_TP| over max
    |w_TP - w_0|. Later steps are not compared leaf by leaf: a token
    routed otherwise (a rounding flip, or a drop that GShard's per-group
    capacity makes and EP's per-expert one does not) gives each expert
    it reaches, and from there every token those experts serve, another
    update. Each expert's own gaps are printed (an expert that barely
    moved reads an ulp of |w| as a large share of its movement)."""
    assignments, per_step, drops, touched = flips
    first = {x["run"]: x for x in lines if x["rank"] == 0
             and x["run"].startswith("b_")}
    b = first["b_tp"]
    loss_rel = max(abs(a - c) / abs(c) for a, c in
                   zip(first["b_ep"]["losses"], b["losses"]))
    line = {"phase": "moe_parallel", "run": "b", "assignments": assignments,
            "flips_per_step": per_step,
            "flip_frac": sum(per_step) / assignments,
            "drops_per_step_tp_ep": drops, "experts_perturbed": touched,
            "loss_rel_ep_vs_tp": loss_rel,
            "first_step_routes_alike": per_step[0] == 0
            and drops[0][0] == drops[0][1] == 0}
    for tag in ("max", "norm"):
        line[f"leaf_{tag}_gap_over_move"] = b[f"leaf_{tag}_gap_over_move"]
        line[f"worst_leaf_{tag}"] = b[f"worst_leaf_{tag}"]
        line[f"expert_{tag}_gap_over_move"] = [
            max(r) for r in b[f"expert_{tag}_gap_over_move"]]
    emit(line)
    if not (sum(per_step) <= MP_FLIP_FRAC * assignments
            and loss_rel <= MP_LOSS_RTOL
            and line["first_step_routes_alike"]
            and line["leaf_max_gap_over_move"] <= MP_MOVE_FRAC):
        return [f"b: {line}"]
    return []


def _moe_parallel_worker(out: str) -> int:
    """One rank of the moe_parallel phase: (a) and (c) on a job of 2
    ranks, (b) on a job of 4; writes its lines."""
    ctx = distributed.maybe_initialize()
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []
    if ctx.num_processes == 2:
        for fn in (_mp_tp_line, _mp_ep_line):
            lines.append(fn(ctx))
            gc.collect()
            torch.cuda.empty_cache()
        lines.append(_mp_fed_line(ctx, out))
    else:
        tp = _mp_kimi_run(ctx, "tp", out)
        ep = _mp_kimi_run(ctx, "ep", out)
        per_leaf, per_expert = _mp_kimi_compare(ctx.process_id, tp[1:],
                                                ep[1:], tp[0]["experts"])
        layout = tp[2].layout
        name = lambda i: "/".join(map(str, layout.paths[i]))
        every = torch.ones(len(layout.paths), dtype=torch.bool,
                           device="cuda")

        def ratios(t, norm):
            """gap over movement: of the max, or of the 2-norm"""
            a, b = (t[1, 0], t[1, 1]) if norm else (t[0, 0], t[0, 1])
            if norm:
                a, b = a.sqrt(), b.sqrt()
            return a / b.clamp(min=1e-30)
        for norm, tag in ((True, "norm"), (False, "max")):
            rel = torch.where(every, ratios(per_leaf, norm), 0.0)
            worst = int(torch.argmax(rel))
            for line in (tp[0], ep[0]):
                line[f"leaf_{tag}_gap_over_move"] = float(rel[worst])
                line[f"worst_leaf_{tag}"] = name(worst)
                line[f"expert_{tag}_gap_over_move"] = ratios(
                    per_expert, norm).tolist()          # (3 stacks, E)
        lines += [tp[0], ep[0]]
    with open(os.path.join(out, f"rank{ctx.process_id}.json"), "w") as fh:
        json.dump(lines, fh)
    return 0


def _mp_spawn(out, ranks, backend):
    # the ranks share a card with this process's cache: segments that
    # grow in place keep a rank's freed blocks usable
    env = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    if backend == "nccl":
        env["NCCL_SOCKET_IFNAME"] = os.environ.get("NCCL_SOCKET_IFNAME", "lo")
    distributed.spawn_local(
        [sys.executable, os.path.abspath(__file__), MP_WORKER, out], ranks,
        backend=backend, local_devices=1 if backend == "gloo" else None,
        env=env, timeout_s=900)
    lines = []
    for r in range(ranks):
        with open(os.path.join(out, f"rank{r}.json")) as fh:
            lines += json.load(fh)
    return lines


def phase_moe_parallel():
    """The MoE layer on the mesh (--moe-parallel-worker), after tp_train:

    (a) one card, 2 gloo ranks: DeepSeek-V2's MoE layer at full width
        (160 experts + 2 shared, d 5120, moe_d_ff 1536, top-6; the
        experts 15.1 GB in f32), f32, B·S = 2 x 1,024, forward and
        backward of sum(out * proj) + aux: tensor-parallel on (1 x 2) at
        the config's capacity factor, and expert-parallel on (2 x 1) at
        8, each against one process's layer at the same factor (EP's in
        two token groups), run in each rank's turn: the output, aux and
        every leaf's gradient within MP_RTOL of its max, the expert ids
        equal (across the TP ranks and to one process's);
    (c) the same job: the CPU test's federated Kimi-K2 SMOKE run on the
        trainer's tensor-parallel route, (1 x 2), K = 4, 2 rounds, one
        feddpc_dots and one feddpc_batched_epilogue a rank a round,
        against one process's run on the CPU (MP_FED_RTOL);
    (b) four cards or more, 4 NCCL ranks: Kimi-K2 at full width, 2 layers
        (1 dense + 1 MoE, kimi_serve's cut; 19.9e9 params, f32), B = 2 x
        1,024, MP_KIMI_STEPS SGD steps at capacity factor 8 on (1 x 4)
        TP and on (2 x 2) EP, the two held against each other (one
        process cannot hold the model): expert-id flips at most
        MP_FLIP_FRAC of the assignments, losses within MP_LOSS_RTOL,
        and after the first step, where both start from one point and
        route alike, every leaf within MP_MOVE_FRAC of its movement
        (``_mp_b_gates``).

    Each rank prints its peak, its bytes at rest, its seconds and its
    collectives' count and ms."""
    cards = torch.cuda.device_count()
    tic = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # what this process still holds on the card beside the ranks
    emit({"phase": "moe_parallel",
          "parent_allocated_gib": torch.cuda.memory_allocated() / 2 ** 30,
          "parent_reserved_gib": torch.cuda.memory_reserved() / 2 ** 30})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as out:
        lines = _mp_spawn(out, 2, "gloo")
        want = _mp_fed_trainer("cpu", False)
        with want:
            want.run()
        got = torch.from_numpy(np.load(os.path.join(out, "c_params.npy")))
        fed_rel = float((got - want.flat).abs().max()
                        / want.flat.abs().max())
        flips = None
        if cards >= 4:
            lines += _mp_spawn(out, 4, "nccl")
            flips = _mp_flips(out, get_config(KIMI_ARCH).with_(
                capacity_factor=MP_EP_CF))
    for line in lines:
        emit(line)
    failures = []
    for line in (x for x in lines if x["run"] in ("a_tp", "a_ep")):
        if not (line["out_rel"] <= MP_RTOL and line["aux_rel"] <= MP_RTOL
                and line["grad_rel"] <= MP_RTOL
                and line["expert_ids_equal"]):
            failures.append(f"{line['run']} rank {line['rank']}: {line}")
    fed = [x for x in lines if x["run"] == "c"]
    want_losses = [h.train_loss for h in want.history]
    loss_rel = max(abs(a - b) / abs(b) for x in fed
                   for a, b in zip(x["losses"], want_losses))
    emit({"phase": "moe_parallel", "run": "c", "card_vs_cpu_params_rel":
          fed_rel, "card_vs_cpu_loss_rel": loss_rel,
          "losses_cpu": want_losses})
    for x in fed:
        if (x["launches"] != x["expected_launches"]
                or x["route"] != "tensor_parallel"
                or set(x["collective_ms_per_round"])
                & {"param_all_gather", "all_to_all"}):
            failures.append(f"c rank {x['rank']}: {x}")
    if not (fed_rel <= MP_FED_RTOL and loss_rel <= MP_FED_RTOL):
        failures.append(f"c: params {fed_rel}, losses {loss_rel}")
    if flips is not None:
        failures += _mp_b_gates(lines, flips)
    emit({"phase": "moe_parallel", "cards": cards,
          "runs": sorted({x["run"] for x in lines}),
          "seconds": time.perf_counter() - tic})
    if failures:
        raise AssertionError("moe_parallel: " + "; ".join(failures))



def phase_serve_batched():
    """The batched serving example (repro_torch.examples.serve_batched:
    StarCoder2-3B, Falcon-Mamba-7B and DeepSeek-V2 SMOKE, batch 4, prompt
    24, gen 12) on the card, its printed lines kept: the serving kernels'
    counts set to 0 just before and read just after must be the three
    runs' ``_serve_want``."""
    _reset_serve_launches()                # this path starts here
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve_batched_example.main(["--device", "cuda"])
    launches = _serve_launches()
    want = {name: 0 for name in SERVE_KERNELS}
    for arch in serve_batched_example.ARCHS:
        for name, n in _serve_want(get_config(arch, smoke=True),
                                   serve_batched_example.GEN).items():
            want[name] += n
    emit({"phase": "serve_batched", "lines": buf.getvalue().splitlines()[:3],
          "tok_per_s": {arch: stats["tok_per_s"]
                        for arch, (_, stats) in out.items()},
          **{f"{name}_launches": n for name, n in launches.items()}})
    if launches != want:
        raise AssertionError(f"serve_batched: launches {launches}, expected "
                             f"{want}")
    for arch, (tokens, _) in out.items():
        _check_tokens(f"serve_batched {arch}", tokens,
                      (serve_batched_example.BATCH,
                       serve_batched_example.GEN),
                      get_config(arch, smoke=True).vocab_size)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == MR_WORKER:
        return _multirank_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == MA_WORKER:
        return _model_axis_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == AR_WORKER:
        return _async_ranks_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == TP_WORKER:
        return _tp_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == MP_WORKER:
        return _moe_parallel_worker(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs a card",
              file=sys.stderr)
        return 1
    smi = phase_build()
    rows = phase_kernels() + phase_folds() + phase_guard_epilogue()
    sr_row = phase_int8_sr()
    project_launches = phase_project_and_scale()
    launches = phase_trainer()
    phase_ingest()
    phase_checkpoint()
    phase_multirank()
    phase_model_axis()
    rank_launches = phase_async_ranks()
    # the one-client epilogue's path is project_and_scale, not a round
    launches["feddpc_fused_epilogue"] = \
        project_launches["feddpc_fused_epilogue"]
    rows.append(sr_row)
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} never launched on the "
                                 "main path")
        # launches the async_ranks phase's ranks made, summed over them
        row["rank_launches"] = rank_launches.get(row["name"], 0)
    for name in ("feddpc_guard_dots", "feddpc_buffer_fold",
                 "feddpc_dequant_buffer_fold", "int8_sr_quantize"):
        if not rank_launches.get(name):
            raise AssertionError(f"{name} never launched on the ranks of "
                                 "the async_ranks phase")
    phase_parity()
    fa_row = phase_attention()
    fa_row["launches"] = phase_serve(SERVE_ARCH, "flash_attention")
    fa_row["rank_launches"] = 0
    rows.append(fa_row)
    phase_serve_parity(SERVE_ARCH)
    ss_row = phase_ssm_kernels()
    ss_row["launches"] = phase_serve(SSM_ARCH, "ssm_scan")
    ss_row["rank_launches"] = 0
    rows.append(ss_row)
    phase_serve_parity(SSM_ARCH)
    phase_tp_train(phase_lm_train())
    phase_moe_parallel()
    phase_lm_fl()
    phase_serve(VLM_ARCH, "flash_attention")
    phase_quickstart()
    phase_lm_parity()
    phase_serve(WHISPER_ARCH, "flash_attention")
    for arch, cut, dtypes in MOE_SERVE:
        phase_serve(arch, "flash_attention", dtypes, cut)
    phase_whisper_train()
    phase_moe_parity()
    phase_serve_batched()
    keys = ("name", "route", "source", "replaces", "launches",
            "rank_launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
