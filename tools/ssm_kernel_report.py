"""What the ssm_scan kernel compiles to and how long it takes, for one
checkout: chip_smoke.py's build report of each kernel instance (ptxas's
registers and spills; the SASS instruction mix of the function and of its
hot loop — the innermost loop of the state exponentials — with the
FP32-issue time it implies at the prefill shape), then chip_smoke.py's
timers at Falcon-Mamba-7B's prefill and decode shapes (B 8, D_in 8192, N
16; S 1024, and S 1 from a carried state), f32 and bf16, unfused and,
where the checkout's kernel takes them, with dt's bias and softplus and
the gate by z.

``--src DIR`` takes the port from DIR/src — an older commit unpacked there
— while the report, the timers and the inputs stay this checkout's, so two
versions of the kernel meet the same timers in one run. Prints JSON lines.
Needs the card:

    python3 tools/ssm_kernel_report.py [--src DIR] [--no-time]
"""
from __future__ import annotations

import argparse
import functools
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=ROOT,
                        help="checkout whose src/repro_torch is measured")
    parser.add_argument("--no-time", action="store_true",
                        help="only the build report")
    args = parser.parse_args()
    src = os.path.join(os.path.abspath(args.src), "src")
    sys.path.insert(0, src)
    import repro_torch  # noqa: F401  (chip_smoke's imports resolve here)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("ssm_kernel_report: needs a CUDA card", file=sys.stderr)
        return 1
    smi = cs._smi("name,power.limit")
    clock = cs._max_sm_clock_mhz()
    for name, row in cs.ssm_sass_report(cs.ss_ops.build(), clock).items():
        cs.emit({"src": src, "kernel": name, "nvidia_smi": smi,
                 "max_sm_clock_mhz": clock, **row})
    if args.no_time:
        return 0
    fused_ok = "dt_bias" in inspect.signature(cs.ss_ops.ssm_scan).parameters
    gen = torch.Generator(device="cuda").manual_seed(6)
    for label in cs.SS_TIMED:
        case = next(c for c in cs.SS_CASES if c[0] == label)
        for dtype in (torch.float32, torch.bfloat16):
            case_args = cs._ssm_case(gen, case, dtype)
            for fused in (False, True) if fused_ok else (False,):
                scan_args, kw = (cs._ssm_fused(gen, case_args, dtype)
                                 if fused else (case_args, {}))
                kern = functools.partial(cs.ss_ops.ssm_scan, *scan_args,
                                         **kw)
                ms, ms_one = cs.cuda_ms(kern)
                cs.emit({"src": src, "kernel_source": str(cs.ss_ops.SOURCE),
                         "case": label, "dtype": str(dtype)[6:],
                         "fused": fused, "ms": ms, "ms_one_call": ms_one,
                         "ms_cold": cs.cuda_ms_cold(kern),
                         "ms_cold_spin": cs.cuda_ms_cold(kern, spin=True),
                         "nvidia_smi": smi})
                del scan_args, kw
            del case_args
    return 0


if __name__ == "__main__":
    sys.exit(main())
