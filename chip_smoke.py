#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing JSON lines; any failure raises and exits non-zero:

  1. build    nvcc-builds the FedDPC, flash-attention and ssm_scan
              libraries from the checkout's sources, all three at once;
              prints the card's name, power limit and top SM clock
              (nvidia-smi), ptxas's registers and spills of each
              flash-attention kernel and the count of tensor-core (HMMA)
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
              path), median of 20 windows.
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
              regime with guard, faults and deadline (6 rounds). The
              launch counts are set to 0 just before each run and read
              just after; each round must launch the kernels of its
              regime. The chaos runs must quarantine exactly the plan's
              targets among the rows that arrive. The last round of sync
              FedDPC, FedAvg, sync chaos and async-int8 runs under
              torch.profiler: device time by kernel and by category (the
              codec's encode and decode as their own) and the card's idle
              share.
  5. parity   LeNet5 at quickstart size on the card and on the CPU from
              the same initial params — 2 sync FedDPC rounds, 3
              buffered-async int8 rounds with error feedback, and 3 sync
              rounds with guard, faults and deadline; the per-round losses
              (and the chaos counters) must agree.

  6. attention  flash_attention against its plain version on the card,
              f32 and bf16: StarCoder2-3B's prefill (B = 8, Sq = 1024,
              Sk = 1056 with the last 32 slots empty, H = 24, KV = 2,
              D = 128) and decode (Sq = 1) shapes, a decode against a
              long cache (Sk = 8192), a ragged shape, a ring-cache decode
              with a window, the soft cap and a batch row whose keys are
              all empty (exactly 0). Each line names the kernel's route
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
              and decode step must each hold exactly one flash_attention
              kernel a layer. Then, on the same params and prompts, the
              kernel path against the plain path (attn_impl="reference"):
              the prefill's last logits and 8 teacher-forced decode steps.
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
              op a layer (the conv's; the gate's is in the scan), counted
              as torch ops, and no more such kernels than ops,
              and the decode step's launches on a line of their own; then
              the kernel path against the plain path (ssm_impl=
              "reference") on the same params and prompts.
 11. serve ssm parity  Falcon-Mamba SMOKE on the card and on the CPU from
              the same params: prefill plus 4 teacher-forced decode steps.

The last lines are the kernels' JSON summary, the nvidia-smi line and
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result. It imports torch and the port, nothing of JAX.
"""
from __future__ import annotations

import collections
import functools
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
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
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.core.runtime import ExponentialRuntime  # noqa: E402
from repro_torch.core.samplers import UniformSampler  # noqa: E402
from repro_torch.ingest.images import (StreamingImageSource,  # noqa: E402
                                       build_federated_image_data)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.feddpc_project import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ss_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as ss_ref  # noqa: E402
from repro_torch.launch.serve import serve_lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.vision import (init_vision,  # noqa: E402
                                       vision_accuracy, vision_loss_fn)

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
SERVE_B, SERVE_PROMPT, SERVE_GEN = 8, 1024, 32
SERVE_STEPS = 8               # teacher-forced steps, kernel vs plain path
SMOKE_STEPS = 4               # ... and card vs CPU on the SMOKE config
SERVE_F32_RTOL = 1e-3         # kernel vs plain logits, relative to max |logit|
SERVE_BF16_TOP1 = 0.9         # kernel vs plain top-1 agreement in bf16
SMOKE_ATOL = 1e-4             # card vs CPU SMOKE logits, f32
# (label, B, Sq, Sk, H, KV, D, window, soft_cap, empty trailing slots,
#  position of the first query, a batch row with every slot empty)
FA_CASES = (
    ("prefill", 8, 1024, 1056, 24, 2, 128, 0, 0.0, 32, 0, False),
    ("decode", 8, 1, 1056, 24, 2, 128, 0, 0.0, 16, 1039, False),
    ("decode_long", 8, 1, 8192, 24, 2, 128, 0, 0.0, 16, 8175, False),
    ("ragged", 2, 100, 300, 8, 2, 64, 0, 0.0, 0, 200, False),
    ("ring_decode_window", 4, 1, 1056, 24, 2, 128, 128, 0.0, 32, 2999,
     False),
    ("soft_cap", 2, 256, 256, 24, 2, 128, 0, 30.0, 0, 0, False),
    ("all_empty_row", 3, 16, 200, 8, 2, 128, 0, 0.0, 0, 184, True),
)
FA_TIMED = ("prefill", "decode", "decode_long")
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
    """All three libraries at once: one nvcc per source, started
    together."""
    tic = time.perf_counter()
    mods = (ops, fa_ops, ss_ops)
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        futures = [pool.submit(mod.build) for mod in mods]
        paths = [f.result() for f in futures]
    seconds = time.perf_counter() - tic
    smi = _smi("name,power.limit")
    emit({"phase": "build", "libraries": [p.name for p in paths],
          "nvcc_seconds": dict(_build.build_seconds), "seconds": seconds,
          "nvidia_smi": smi, "max_sm_clock_mhz": _max_sm_clock_mhz(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
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
    return smi


def _ptxas_report(log: str, names=FA_KERNEL_NAMES) -> dict:
    """kernel<template arguments> -> registers and spill bytes, from nvcc
    -Xptxas -v's output, for the kernels named in ``names``."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            base = next((n for n in names[::-1] if n in mangled), None)
            if base is None:
                name = None
                continue
            args = mangled.split(base, 1)[1].split("EEEv")[0]
            name = f"{base}<{args}>"
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
            mangled = line.split("Function :")[1].strip()
            base = next((n for n in names if n in mangled), None)
            fn = None
            if base is not None:
                args = mangled.split(base, 1)[1].split("EEEv")[0]
                fn = out.setdefault(f"{base}<{args}>",
                                    {"ins": [], "labels": {}})
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


def _resnet18_offsets():
    params = init_vision(paper_resnet18.CONFIG,
                         torch.Generator().manual_seed(0))
    return layout_of(params).leaf_offsets


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
                   "ms": ms, "ms_one_call": ms_one, "plain_ms": plain_ms,
                   "bound_ms": b_ms,
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


def _image_task(cfg, num_classes, samples_per_class, test_per_class):
    data = build_federated_image_data(
        num_classes=num_classes, num_clients=30, alpha=0.2,
        samples_per_class=samples_per_class, test_per_class=test_per_class,
        seed=0)
    source = StreamingImageSource(data, batch_size=64)
    return data, source, functools.partial(vision_loss_fn, cfg)


def _trainer(cfg, data, source, loss_fn, params, name, rounds, device,
             exec_kw=None, runtime=None, fault_plan=None):
    te_x = torch.from_numpy(data.test_images).to(device)
    te_y = torch.from_numpy(data.test_labels).to(device)
    algo = AlgoConfig(name=name, eta_l=0.02, eta_g=0.02,
                      hyper=FedDPCHyper(lam=1.0) if name == "feddpc"
                      else None)
    return FederatedTrainer(
        loss_fn, params, data.num_clients, source,
        ExecConfig(rounds=rounds, clients_per_round=10, seed=0,
                   eval_every=1, **(exec_kw or {})),
        lambda p: vision_accuracy(cfg, p, te_x, te_y), algo=algo,
        sampler=UniformSampler(data.num_clients, 10), runtime=runtime,
        fault_plan=fault_plan, device=device)


CODEC_CATEGORY = "codec encode/decode (plain PyTorch)"


def _category(kernel: str) -> str:
    if any(tag in kernel for tag in ("dots_kernel", "fold_kernel",
                                     "epilogue_kernel")):
        return "feddpc kernels"
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

        def wrapped(*args, _fn=fn, _name=f"codec.{meth}"):
            with torch.profiler.record_function(_name):
                return _fn(*args)
        setattr(codec, meth, wrapped)


def _kernel_time(events, category):
    """Device kernels of a profile: (spans, busy µs — the union of their
    intervals —, ms by kernel name, ms by ``category(name)``)."""
    spans = sorted((e.time_range.start, e.time_range.end, e.key)
                   for e in events if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("codec."))
    busy_us, end = 0.0, float("-inf")
    by_name, by_cat = {}, {}
    for lo, hi, name in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e3
        cat = category(name)
        by_cat[cat] = by_cat.get(cat, 0.0) + (hi - lo) / 1e3
    return spans, busy_us, by_name, by_cat


def profile_round(trainer, t):
    """Run round t (and its eval) under torch.profiler: kernel time by
    name and by category, and the card's busy share of the window — the
    union of the kernels' intervals over the window's wall time. With a
    lossy codec the kernels launched inside its encode and decode are a
    category of their own."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tic = time.perf_counter()
        rec = trainer.run_round(t)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - tic
    events = prof.events()
    spans, busy_us, by_name, by_cat = _kernel_time(events, _category)
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
    emit({"phase": "profile", "round": t, "round_seconds": rec.seconds,
          "window_seconds": window_s, "kernels": len(spans),
          "kernel_sum_ms": sum(by_name.values()),
          "device_busy_ms": busy_us / 1e3,
          "device_idle_share": 1.0 - busy_us / 1e6 / window_s,
          "by_category_ms": by_cat, "codec_kernels": codec_n,
          "feddpc_kernels_ms": {k: v for k, v in by_name.items()
                                if _category(k) == "feddpc kernels"},
          "top_ms": [[name[:70], ms] for name, ms in top]})
    return rec


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
RUNS = (
    ("feddpc", "feddpc", {}, False, 3,
     ("feddpc_dots", "feddpc_batched_epilogue"), None),
    ("fedavg", "fedavg", {}, False, 3, (), None),
    ("feddpc_int8", "feddpc", {"codec": "int8"}, False, 4,
     ("feddpc_dots", "feddpc_dequant_batched_epilogue"), None),
    ("feddpc_async", "feddpc", ASYNC, True, 4,
     ("feddpc_dots", "feddpc_buffer_fold"), None),
    ("feddpc_async_int8_ef", "feddpc", ASYNC_INT8_EF, True, 4,
     ("feddpc_dots", "feddpc_dequant_buffer_fold"), None),
    ("feddpc_chaos", "feddpc", CHAOS, True, 4,
     ("feddpc_guard_dots", "feddpc_dots", "feddpc_batched_epilogue"),
     SYNC_PLAN),
    # the guard rewrites rows after decode (and the faults before it), so
    # the fold reads the decoded f32 rows, not the int8 payload
    ("feddpc_async_int8_chaos", "feddpc", {**ASYNC_INT8_EF, **CHAOS}, True,
     6, ("feddpc_guard_dots", "feddpc_dots", "feddpc_buffer_fold"),
     ASYNC_PLAN),
)
PROFILED = ("feddpc", "fedavg", "feddpc_async_int8_ef", "feddpc_chaos")


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
    params = init_vision(cfg, torch.Generator().manual_seed(0))
    launches = {fn.__name__: 0 for fn in ops.KERNELS}
    for label, name, exec_kw, exp, rounds, want, plan_kw in RUNS:
        plan = (None if plan_kw is None
                else FaultPlan.seeded(PLAN_SEED, **plan_kw))
        trainer = _trainer(cfg, data, source, loss_fn, params, name, rounds,
                           "cuda", exec_kw,
                           ExponentialRuntime(mean=1.0) if exp else None,
                           plan)
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
        ops.reset_launches()               # this path starts here
        for t in range(rounds):
            before = [fn.launches for fn in ops.KERNELS]
            rec = (profile_round(trainer, t)
                   if label in PROFILED and t == rounds - 1
                   else trainer.run_round(t))
            added = {fn.__name__: fn.launches - b
                     for fn, b in zip(ops.KERNELS, before)}
            expect = {k: int(k in want) for k in added}
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
        run_launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
        for k, v in run_launches.items():
            launches[k] += v
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
        emit({"phase": "trainer", "run": label, "launches": run_launches,
              "seconds_per_round_after_0": [r.seconds for r in hist[1:]],
              "staleness_mean": [r.staleness_mean for r in hist],
              "staleness_max": [r.staleness_max for r in hist],
              "comm_bytes_up": [r.comm_bytes_up for r in hist],
              "quarantined": [r.quarantined for r in hist],
              "clipped": [r.clipped for r in hist],
              "deadline_dropped": [r.deadline_dropped for r in hist],
              "peak_memory_gib":
                  torch.cuda.max_memory_allocated() / 2 ** 30})
        del trainer
    emit({"phase": "trainer", "launches": launches})
    return launches


def phase_parity():
    cfg = paper_lenet5.CONFIG
    data, source, loss_fn = _image_task(cfg, 10, 100, 20)
    params = init_vision(cfg, torch.Generator().manual_seed(0))
    for label, exec_kw, exp, rounds, plan_kw in (
            ("feddpc", {}, False, 2, None),
            ("feddpc_async_int8_ef", ASYNC_INT8_EF, True, 3, None),
            ("feddpc_chaos", CHAOS, True, 3, SYNC_PLAN)):
        runs = {}
        for device in ("cuda", "cpu"):
            trainer = _trainer(
                cfg, data, source, loss_fn, params, "feddpc", rounds,
                device, exec_kw,
                ExponentialRuntime(mean=1.0) if exp else None,
                None if plan_kw is None
                else FaultPlan.seeded(PLAN_SEED, **plan_kw))
            runs[device] = (trainer.run(), trainer.flat.cpu())
        (h_gpu, w_gpu), (h_cpu, w_cpu) = runs["cuda"], runs["cpu"]
        diffs = [abs(a.train_loss - b.train_loss)
                 for a, b in zip(h_gpu, h_cpu)]
        emit({"phase": "parity", "run": label, "model": cfg.name,
              "loss_cuda": [r.train_loss for r in h_gpu],
              "loss_cpu": [r.train_loss for r in h_cpu],
              "staleness_max": [r.staleness_max for r in h_gpu],
              "quarantined": [r.quarantined for r in h_gpu],
              "deadline_dropped": [r.deadline_dropped for r in h_gpu],
              "max_loss_diff": max(diffs),
              "max_param_diff": float((w_gpu - w_cpu).abs().max())})
        for key in ("staleness_max", "quarantined", "clipped",
                    "deadline_dropped", "comm_bytes_up"):
            if [getattr(r, key) for r in h_gpu] != \
                    [getattr(r, key) for r in h_cpu]:
                raise AssertionError(f"{label}: card and CPU differ in "
                                     f"{key}")
        if not max(diffs) <= PARITY_ATOL:
            raise AssertionError(f"{label}: card vs CPU losses differ by "
                                 f"{max(diffs)} > {PARITY_ATOL}")


def _attention_case(gen, case, dtype):
    """The inputs of one FA_CASES entry on the card: q, k, v of dtype,
    int32 positions (queries at consecutive positions from q0; the cache
    slots rolled as a ring buffer when the first query is past Sk)."""
    (_, b, sq, sk, h, kv, d, window, soft_cap, empty, q0,
     empty_row) = case
    q, k, v = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]
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


def _teacher_forced(cfg, params, prompts, forced, impl):
    """Prefill ``prompts``, then one decode step per column of ``forced``
    (the same tokens whatever the model predicts): the last-position
    logits of each, stacked (1 + steps, B, V) in f32. ``impl`` ("auto"
    or "reference") is both the attention's and the SSM mixer's."""
    b, s = prompts.shape
    steps = forced.shape[1]
    dtype = params["embed"].dtype
    states = tf.init_states(cfg, b, s + steps, dtype, prompts.device)
    with torch.inference_mode():
        logits, states, _ = tf.lm_forward(cfg, params, prompts,
                                          states=states, attn_impl=impl,
                                          ssm_impl=impl,
                                          logits_slice_last=True)
        out = [logits[:, -1].float()]
        for i in range(steps):
            pos = torch.full((b, 1), s + i, dtype=torch.int32,
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


def profile_serve(cfg, params, prompts, kernel: str):
    """One prefill and one decode step under torch.profiler (after
    serve_lm has warmed both): per step the window's wall time, the
    card's busy time (the union of kernel intervals) and idle share,
    kernel time by category and the launches per step; each step must
    hold exactly one flash-attention kernel a layer when ``kernel`` is
    flash_attention, and none otherwise. Then one more decode step in
    which any call that waits for the card raises."""
    b, s = prompts.shape
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    states = tf.init_states(cfg, b, s + 2, params["embed"].dtype, "cuda")
    tok = prompts
    pos = None
    for step in ("prefill", "decode"):
        torch.cuda.synchronize()
        with torch.inference_mode(), torch.profiler.profile(
                activities=acts) as prof:
            tic = time.perf_counter()
            logits, states, _ = tf.lm_forward(cfg, params, tok, positions=pos,
                                              states=states,
                                              logits_slice_last=True)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            torch.cuda.synchronize()
            window_s = time.perf_counter() - tic
        spans, busy_us, by_name, by_cat = _kernel_time(prof.events(),
                                                       _serve_category)
        flash = sum(1 for *_, name in spans
                    if _serve_category(name) == "flash_attention kernel")
        want = cfg.num_layers if kernel == "flash_attention" else 0
        if flash != want:
            raise AssertionError(f"serve profile {step}: {flash} flash-"
                                 f"attention kernels, expected {want}")
        # the mixer's eager softplus chain (its log1p) and gate (a second
        # silu a layer) are folded into the scan: one silu a layer is left.
        # Counted exactly as the step's torch ops (recorded on the host);
        # the profiler can miss a device event of a ~1,600-kernel step
        # (one silu kernel short in one run), so the kernels may not
        # exceed those counts
        ops = {key: sum(1 for e in prof.events()
                        if e.device_type == DeviceType.CPU
                        and e.key == f"aten::{key}")
               for key in ("log1p", "silu")}
        mixer = {key: sum(1 for *_, name in spans if key in name)
                 for key in ("log1p", "silu")}
        if kernel == "ssm_scan" and (
                ops != {"log1p": 0, "silu": cfg.num_layers}
                or any(mixer[key] > ops[key] for key in ops)):
            raise AssertionError(f"serve profile {step}: mixer ops {ops}, "
                                 f"kernels {mixer}, expected no log1p and "
                                 "one silu a layer")
        top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:6]
        dtype = str(params["embed"].dtype)[6:]
        emit({"phase": "serve_profile", "arch": cfg.name, "dtype": dtype,
              "step": step, "window_ms": 1e3 * window_s,
              "kernels": len(spans), "flash_attention_kernels": flash,
              **{f"{key}_kernels": n for key, n in mixer.items()},
              **{f"{key}_ops": n for key, n in ops.items()},
              "device_busy_ms": busy_us / 1e3,
              "device_idle_share": 1.0 - busy_us / 1e6 / window_s,
              "by_category_ms": by_cat,
              "top_ms": [[name[:70], ms] for name, ms in top]})
        if step == "decode":
            emit({"phase": "serve_decode_launches", "arch": cfg.name,
                  "dtype": dtype, "launches_per_step": len(spans)})
        pos = torch.full((b, 1), s, dtype=torch.int32, device="cuda")
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


def phase_serve(arch: str, kernel: str) -> int:
    """serve_lm on ``arch`` at full width and depth, f32 then bf16, with
    the serving kernels' counts set to 0 just before each run and read
    just after: ``kernel`` must launch num_layers x gen times, the others
    never. Then a profiled prefill and decode step, and the kernel path
    against the plain path on the same params and prompts (each timed).
    Returns the f32 run's launch count of ``kernel``."""
    cfg = get_config(arch)
    counts = {}
    for dtype in (torch.float32, torch.bfloat16):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = tf.init_lm(cfg, gen, dtype)
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                                generator=gen, device="cuda")
        n_params = sum(t.numel() for t in tree_leaves(params))
        for mod in SERVE_KERNELS.values():
            mod.reset_launches()           # this path starts here
        tokens, stats = serve_lm(cfg, SERVE_B, SERVE_PROMPT, SERVE_GEN,
                                 device="cuda", dtype=dtype, params=params,
                                 prompts=prompts)
        launches = _serve_launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {name: cfg.num_layers * SERVE_GEN if name == kernel else 0
                for name in SERVE_KERNELS}
        if launches != want:
            raise AssertionError(f"serve {arch} {dtype}: launches "
                                 f"{launches}, expected {want}")
        if tuple(tokens.shape) != (SERVE_B, SERVE_GEN) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            raise AssertionError(f"serve {dtype}: tokens {tokens.shape} out "
                                 "of range")
        counts[dtype] = launches[kernel]
        profile_serve(cfg, params, prompts, kernel)
        forced = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_STEPS),
                               generator=gen, device="cuda")
        path_s = {}
        for impl in ("auto", "reference"):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            logits = _teacher_forced(cfg, params, prompts, forced, impl)
            torch.cuda.synchronize()
            path_s[impl] = time.perf_counter() - tic
            if impl == "auto":
                kern = logits
        plain = logits
        if not bool(torch.isfinite(kern).all() & torch.isfinite(plain).all()):
            raise AssertionError(f"serve {dtype}: non-finite logits")
        diff = float((kern - plain).abs().max())
        scale = max(1.0, float(plain.abs().max()))
        top1 = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
        line = {"phase": "serve", "arch": cfg.name, "dtype": str(dtype)[6:],
                "layers": cfg.num_layers, "d_model": cfg.d_model,
                "params": n_params, "batch": SERVE_B,
                "prompt_len": SERVE_PROMPT, "gen": SERVE_GEN, **stats,
                "decode_step_ms": 1e3 * stats["decode_s"] / (SERVE_GEN - 1),
                **{f"{name}_launches": n for name, n in launches.items()},
                "peak_memory_gib": peak_gib, "tokens_in_range": True,
                "sample": tokens[0, :8].tolist(),
                "parity_steps": 1 + SERVE_STEPS,
                "kernel_path_s": path_s["auto"],
                "plain_path_s": path_s["reference"],
                "kernel_vs_plain_max_abs_logit_diff": diff,
                "max_abs_logit": float(plain.abs().max()),
                "kernel_vs_plain_top1_agreement": top1,
                "logits_finite": True}
        emit(line)
        if dtype == torch.float32 and not diff <= SERVE_F32_RTOL * scale:
            raise AssertionError(f"serve f32: kernel vs plain logits differ "
                                 f"by {diff} > {SERVE_F32_RTOL} x {scale}")
        if dtype == torch.bfloat16 and not top1 >= SERVE_BF16_TOP1:
            raise AssertionError(f"serve bf16: kernel vs plain top-1 "
                                 f"agreement {top1} < {SERVE_BF16_TOP1}")
        del params, kern, plain, logits
    torch.cuda.empty_cache()
    return counts[torch.float32]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs a card",
              file=sys.stderr)
        return 1
    smi = phase_build()
    rows = phase_kernels() + phase_folds() + phase_guard_epilogue()
    project_launches = phase_project_and_scale()
    launches = phase_trainer()
    # the one-client epilogue's path is project_and_scale, not a round
    launches["feddpc_fused_epilogue"] = \
        project_launches["feddpc_fused_epilogue"]
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} never launched on the "
                                 "main path")
    phase_parity()
    fa_row = phase_attention()
    fa_row["launches"] = phase_serve(SERVE_ARCH, "flash_attention")
    rows.append(fa_row)
    phase_serve_parity(SERVE_ARCH)
    ss_row = phase_ssm_kernels()
    ss_row["launches"] = phase_serve(SSM_ARCH, "ssm_scan")
    rows.append(ss_row)
    phase_serve_parity(SSM_ARCH)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
