"""Time flash_attention at StarCoder2-3B's decode shape (chip_smoke.py's
"decode" case: B 8, Sq 1, Sk 1056 with 16 empty slots, H 24, KV 2, D 128)
in f32 and bf16 with chip_smoke.py's timers: warm (windows of 10 calls),
windows of one call, cold as ``cuda_ms_cold`` times it (the L2 flushed by a
256 MB memset queued before each one-call window: ``ms_cold``) and cold
with a 0.1 ms spin on the card after the flush (``ms_cold_spin``).

``--src DIR`` takes the port from DIR/src — an older commit unpacked there
— while the timers and the inputs stay this checkout's, so two versions of
the kernel meet the same timers in one run. Prints one JSON line a dtype.
Needs the card:

    python3 tools/flash_cold_timers.py [--src DIR]
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=ROOT,
                        help="checkout whose src/repro_torch is timed")
    args = parser.parse_args()
    src = os.path.join(os.path.abspath(args.src), "src")
    sys.path.insert(0, src)
    import repro_torch  # noqa: F401  (chip_smoke's imports resolve here)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("flash_cold_timers: needs a CUDA card", file=sys.stderr)
        return 1
    case = next(c for c in cs.FA_CASES if c[0] == "decode")
    gen = torch.Generator(device="cuda").manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, q_pos, k_pos = cs._attention_case(gen, case, dtype)
        kern = functools.partial(cs.fa_ops.flash_attention, q, k, v, q_pos,
                                 k_pos)
        ms, ms_one = cs.cuda_ms(kern)
        cs.emit({"src": src, "kernel_source": str(cs.fa_ops.SOURCE),
                 "case": case[0], "dtype": str(dtype)[6:], "ms": ms,
                 "ms_one_call": ms_one, "ms_cold": cs.cuda_ms_cold(kern),
                 "ms_cold_spin": cs.cuda_ms_cold(kern, spin=True),
                 "nvidia_smi": cs._smi("name,power.limit",
                                       "csv,noheader")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
