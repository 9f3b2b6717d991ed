#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing JSON lines; any failure raises and exits non-zero:

  1. build    nvcc-builds the FedDPC kernels from the checkout's sources;
              prints the card's name and power limit (nvidia-smi).
  2. kernels  holds every kernel against its plain PyTorch version on the
              card, at the main path's shape (K=10 clients x N=11,220,132
              ResNet18-GN parameters) and at ragged shapes, with and
              without a zero Delta_prev; times kernel and plain version
              with CUDA events beside the kernel's bound.
  3. trainer  the main path: FederatedTrainer runs 3 FedDPC and 3 FedAvg
              rounds of ResNet18-GN at full width (CIFAR-100 shape,
              synthetic Dirichlet(0.2) data, 10 of 30 clients per round)
              with the launch counts set to 0 just before and read just
              after; every FedDPC round must launch each kernel once.
              Each algorithm's last round runs under torch.profiler: its
              device time by kernel and the card's busy share.
  4. parity   2 FedDPC rounds of LeNet5 at quickstart size on the card and
              on the CPU from the same initial params; the per-round
              losses must agree.

The last lines are the kernels' JSON summary, the nvidia-smi line and
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result. It imports torch and the port, nothing of JAX.
"""
from __future__ import annotations

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import paper_lenet5, paper_resnet18  # noqa: E402
from repro_torch.core import projection as proj  # noqa: E402
from repro_torch.core.api import (AlgoConfig, ExecConfig,  # noqa: E402
                                  FederatedTrainer)
from repro_torch.core.baselines import FedDPCHyper  # noqa: E402
from repro_torch.core.samplers import UniformSampler  # noqa: E402
from repro_torch.ingest.images import (StreamingImageSource,  # noqa: E402
                                       build_federated_image_data)
from repro_torch.kernels.feddpc_project import ops, ref  # noqa: E402
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
REPLACES = {"feddpc_dots":
            "src/repro/kernels/feddpc_project/kernel.py:44",
            "feddpc_batched_epilogue":
            "src/repro/kernels/feddpc_project/kernel.py:118"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_build() -> str:
    tic = time.perf_counter()
    path = ops.build()
    seconds = time.perf_counter() - tic
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "build", "library": path.name,
          "nvcc_seconds": ops.build_seconds, "seconds": seconds,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


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
    epi_bytes = 4 * ((k + 2) * n + 2 * k + 2 * n)
    epi_flops = 4 * k * n + 3 * n
    rows = []
    for name, kern, plain, nbytes, flops in (
            ("feddpc_dots", lambda: ops.feddpc_dots(d, p),
             lambda: ref.dots_ref(d, p), dots_bytes, dots_flops),
            ("feddpc_batched_epilogue",
             lambda: ops.feddpc_batched_epilogue(d, p, w, coefs, scales,
                                                 ETA_G),
             lambda: ref.batched_epilogue_ref(d, p, w, coefs, scales,
                                              ETA_G), epi_bytes, epi_flops)):
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain)
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name], "max_abs_err": err[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "K": k, "N": n, "bytes": nbytes, "flops": flops})
        emit({"phase": "timing", **rows[-1]})
    return rows


def _image_task(cfg, num_classes, samples_per_class, test_per_class):
    data = build_federated_image_data(
        num_classes=num_classes, num_clients=30, alpha=0.2,
        samples_per_class=samples_per_class, test_per_class=test_per_class,
        seed=0)
    source = StreamingImageSource(data, batch_size=64)
    return data, source, functools.partial(vision_loss_fn, cfg)


def _trainer(cfg, data, source, loss_fn, params, name, rounds, device):
    te_x = torch.from_numpy(data.test_images).to(device)
    te_y = torch.from_numpy(data.test_labels).to(device)
    algo = AlgoConfig(name=name, eta_l=0.02, eta_g=0.02,
                      hyper=FedDPCHyper(lam=1.0) if name == "feddpc"
                      else None)
    return FederatedTrainer(
        loss_fn, params, data.num_clients, source,
        ExecConfig(rounds=rounds, clients_per_round=10, seed=0,
                   eval_every=1),
        lambda p: vision_accuracy(cfg, p, te_x, te_y), algo=algo,
        sampler=UniformSampler(data.num_clients, 10), device=device)


def _category(kernel: str) -> str:
    if "dots_kernel" in kernel or "epilogue_kernel" in kernel:
        return "feddpc kernels"
    if any(tag in kernel for tag in ("cudnn", "xmma", "fft", "grad",
                                     "pointwise_mult_and_sum_complex")):
        return "convolutions (cuDNN)"
    if "at::native" in kernel:
        return "PyTorch elementwise and reductions"
    return "other"


def profile_round(trainer, t):
    """Run round t (and its eval) under torch.profiler: kernel time by
    name and by category, and the card's busy share of the window — the
    union of the kernels' intervals over the window's wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tic = time.perf_counter()
        rec = trainer.run_round(t)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - tic
    spans = sorted((e.time_range.start, e.time_range.end, e.key)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    by_name, by_cat = {}, {}
    for lo, hi, name in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e3
        cat = _category(name)
        by_cat[cat] = by_cat.get(cat, 0.0) + (hi - lo) / 1e3
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    emit({"phase": "profile", "round": t, "round_seconds": rec.seconds,
          "window_seconds": window_s, "kernels": len(spans),
          "kernel_sum_ms": sum(by_name.values()),
          "device_busy_ms": busy_us / 1e3,
          "device_idle_share": 1.0 - busy_us / 1e6 / window_s,
          "by_category_ms": by_cat,
          "feddpc_kernels_ms": {k: v for k, v in by_name.items()
                                if _category(k) == "feddpc kernels"},
          "top_ms": [[name[:70], ms] for name, ms in top]})
    return rec


def phase_trainer():
    cfg = paper_resnet18.CONFIG
    data, source, loss_fn = _image_task(cfg, 100, 50, 10)
    params = init_vision(cfg, torch.Generator().manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                   # the main path starts here
    for name in ("feddpc", "fedavg"):
        trainer = _trainer(cfg, data, source, loss_fn, params, name, 3,
                           "cuda")
        if trainer.layout.size != N_MAIN:
            raise AssertionError(f"ResNet18-GN has {trainer.layout.size} "
                                 f"parameters, expected {N_MAIN}")
        for t in range(3):
            before = [fn.launches for fn in ops.KERNELS]
            rec = (profile_round(trainer, t) if t == 2
                   else trainer.run_round(t))
            added = [fn.launches - b for fn, b in zip(ops.KERNELS, before)]
            want = [1, 1] if name == "feddpc" else [0, 0]
            if added != want:
                raise AssertionError(f"{name} round {t}: kernel launches "
                                     f"{added}, expected {want}")
            if not math.isfinite(rec.train_loss):
                raise AssertionError(f"{name} round {t}: loss "
                                     f"{rec.train_loss}")
            emit({"phase": "trainer", "model": cfg.name, "algorithm": name,
                  "round": t, "K": 10, "N": trainer.layout.size,
                  "M": trainer._max_batches, "train_loss": rec.train_loss,
                  "seconds": rec.seconds,
                  "test_accuracy": rec.test_accuracy,
                  "diagnostics": rec.diagnostics})
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    emit({"phase": "trainer", "launches": launches,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return launches


def phase_parity():
    cfg = paper_lenet5.CONFIG
    data, source, loss_fn = _image_task(cfg, 10, 100, 20)
    params = init_vision(cfg, torch.Generator().manual_seed(0))
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = _trainer(cfg, data, source, loss_fn, params, "feddpc", 2,
                           device)
        runs[device] = (trainer.run(), trainer.flat.cpu())
    (h_gpu, w_gpu), (h_cpu, w_cpu) = runs["cuda"], runs["cpu"]
    diffs = [abs(a.train_loss - b.train_loss) for a, b in zip(h_gpu, h_cpu)]
    emit({"phase": "parity", "model": cfg.name,
          "loss_cuda": [r.train_loss for r in h_gpu],
          "loss_cpu": [r.train_loss for r in h_cpu],
          "max_loss_diff": max(diffs),
          "max_param_diff": float((w_gpu - w_cpu).abs().max())})
    if not max(diffs) <= PARITY_ATOL:
        raise AssertionError(f"card vs CPU losses differ by {max(diffs)} "
                             f"> {PARITY_ATOL}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs a card",
              file=sys.stderr)
        return 1
    smi = phase_build()
    rows = phase_kernels()
    launches = phase_trainer()
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} never launched on the "
                                 "main path")
    phase_parity()
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
