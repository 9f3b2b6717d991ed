"""What the FedDPC server-step kernels compile to, what the two dequant
folds return and how long all seven take, for one checkout:

  * per kernel instance of the FedDPC library: ptxas's registers and
    spills and the SASS instruction mix (cuobjdump), so that two trees'
    instances can be compared opcode for opcode;
  * a sha256 of w' and Delta_t from both dequant folds, int8 and bf16
    payloads, at fixed seeds: ResNet18-GN's layout (62 leaves, N =
    11,220,132) at K = 10 and 33, and chip_smoke.py's ragged synthetic
    layout (leaves of 1-31 elements) at K = 10 and 33. Equal digests on
    two trees mean bitwise equal results;
  * chip_smoke.py's timers (10-call windows, ``ms``; one call after an L2
    flush and a spin, ``ms_cold_spin``) for the seven kernels at K = 10,
    N = 11,220,132 — the four folds (the dequant folds in int8 and bf16),
    the two reduction passes and the one-client epilogue — beside the
    bound and its share.

``--src DIR`` takes the port from DIR/src — an older commit unpacked there
— while the report, the timers and the inputs stay this checkout's, so two
versions of the kernels meet the same inputs and timers in one run. Prints
JSON lines. Needs the card:

    python3 tools/fold_kernel_report.py [--src DIR]
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGEST_CASES = (("resnet18", 10), ("resnet18", 33), ("synthetic", 10),
                ("synthetic", 33))


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=ROOT,
                        help="checkout whose src/repro_torch is measured")
    args = parser.parse_args()
    src = os.path.join(os.path.abspath(args.src), "src")
    sys.path.insert(0, src)
    import repro_torch  # noqa: F401  (chip_smoke's imports resolve here)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("fold_kernel_report: needs a CUDA card")
    ops, ref = cs.ops, cs.ref
    smi = cs._smi("name,power.limit")
    lib = ops.build()
    ptxas = cs._ptxas_report(lib.with_suffix(".log").read_text(),
                             cs.FEDDPC_KERNEL_NAMES)
    sass = subprocess.run([cs._build.tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    fns = cs._sass_functions(sass, cs.FEDDPC_KERNEL_NAMES)
    for name in sorted(set(ptxas) | set(fns)):
        cs.emit({"src": src, "kernel": name, **ptxas.get(name, {}),
                 "sass": cs._sass_mix(fns[name]["ins"]) if name in fns
                 else None, "nvidia_smi": smi})

    layouts = {"resnet18": cs._resnet18_offsets(),
               "synthetic": torch.tensor(
                   [0] + list(itertools.accumulate(cs.SYNTH_NUMELS)),
                   dtype=torch.int64)}
    for (lname, k), qdtype in itertools.product(
            DIGEST_CASES, (torch.int8, torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(1000 + k)
        q, qscale, qzero, offsets, p, w, coefs, scales, wgts = \
            cs._fold_inputs(gen, k, layouts[lname], qdtype)
        base = (q, qscale, qzero, offsets, p, w, coefs, scales)
        for name, out in (
                ("feddpc_dequant_batched_epilogue",
                 ops.feddpc_dequant_batched_epilogue(*base, cs.ETA_G)),
                ("feddpc_dequant_buffer_fold",
                 ops.feddpc_dequant_buffer_fold(*base, wgts, cs.ETA_G))):
            cs.emit({"src": src, "digest_case": lname, "K": k,
                     "N": int(offsets[-1]),
                     "payload": str(qdtype).replace("torch.", ""),
                     "kernel": name, "sha256_w_dt": _digest(*out)})
        del q, p, w

    gen = torch.Generator(device="cuda").manual_seed(6)
    k, n = cs.K_MAIN, cs.N_MAIN
    offsets = layouts["resnet18"]
    nleaves = offsets.numel() - 1
    cases = []                  # (name, form, call, bytes, flops)
    for qdtype in (torch.int8, torch.bfloat16):
        q, qscale, qzero, offsets, p, w, coefs, scales, wgts = \
            cs._fold_inputs(gen, k, offsets, qdtype)
        base = (q, qscale, qzero, offsets, p, w, coefs, scales)
        form = str(qdtype).replace("torch.", "")
        for name, weighted, call in (
                ("feddpc_dequant_batched_epilogue", False,
                 lambda base=base: ops.feddpc_dequant_batched_epilogue(
                     *base, cs.ETA_G)),
                ("feddpc_dequant_buffer_fold", True,
                 lambda base=base, wgts=wgts: ops.feddpc_dequant_buffer_fold(
                     *base, wgts, cs.ETA_G))):
            cases.append((name, form, call, *cs._fold_bytes_flops(
                k, n, True, weighted, nleaves, q.element_size())))
    d = ref.dequant_ref(q, qscale, qzero, offsets)     # the f32 stack
    d1 = {dt: d[0].to(dt) for dt in (torch.float32, torch.bfloat16)}
    g = ops.dots_num_blocks(n)
    coef, scale = coefs[:1].clone(), scales[:1].clone()
    cases += [
        ("feddpc_batched_epilogue", "float32",
         lambda: ops.feddpc_batched_epilogue(d, p, w, coefs, scales,
                                             cs.ETA_G),
         *cs._fold_bytes_flops(k, n, False, False)),
        ("feddpc_buffer_fold", "float32",
         lambda: ops.feddpc_buffer_fold(d, p, w, coefs, scales, wgts,
                                        cs.ETA_G),
         *cs._fold_bytes_flops(k, n, False, True)),
        ("feddpc_dots", "float32", lambda: ops.feddpc_dots(d, p),
         4 * ((k + 1) * n + 3 * k * g), 4 * k * n + 2 * n),
        ("feddpc_guard_dots", "without_p", lambda: ops.feddpc_guard_dots(d),
         4 * (k * n + 4 * k * g), 3 * k * n)]
    for dt, dv in d1.items():
        cases.append(("feddpc_fused_epilogue", str(dt).replace("torch.", ""),
                      lambda dv=dv: ops.feddpc_fused_epilogue(dv, p, coef,
                                                              scale),
                      *cs._epilogue_bytes_flops(n, dv.element_size())))
    for name, form, call, nbytes, flops in cases:
        ms, ms_one = cs.cuda_ms(call)
        b_ms, b_by = cs.bound_ms(nbytes, flops)
        cs.emit({"src": src, "timing": name, "form": form, "K": k, "N": n,
                 "ms": ms, "ms_one_call": ms_one,
                 "ms_cold_spin": cs.cuda_ms_cold(call, spin=True),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "pct_of_bound": 100.0 * b_ms / ms, "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
