"""What int8_sr's encode kernel compiles to, what it returns and how long
it takes, for one checkout:

  * ptxas's registers and spills of each int8_sr_kernel instance;
  * a sha256 of the codes at fixed seeds (ResNet18-GN's layout, K = 10,
    both counter layouts): equal digests on two trees mean bitwise equal
    codes;
  * chip_smoke.py's timers (10-call windows, ``ms``; one-call windows,
    ``ms_one_call``; one call after an L2 flush and a spin,
    ``ms_cold_spin``) at K = 10, N = 11,220,132 with no block arguments,
    beside its int32-operations bound; where the tree's wrapper takes a
    block, also a client slice's rows 5-9 of 10 and a model
    shard's (rows 5-9, model rank 1 of 2).

``--src DIR`` takes the port from DIR/src — an older commit unpacked there
— while the report, the timers and the inputs stay this checkout's, so two
versions of the kernel meet the same inputs and timers in one run. Prints
JSON lines. Needs the card:

    python3 tools/int8_sr_report.py [--src DIR]
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        raise SystemExit("int8_sr_report: needs a CUDA card")
    sr_ops, jax_prng = cs.sr_ops, cs.jax_prng
    smi = cs._smi("name,power.limit")
    lib = sr_ops.build()
    for name, regs in cs._ptxas_report(lib.with_suffix(".log").read_text(),
                                       ("int8_sr_kernel",)).items():
        cs.emit({"src": src, "kernel": name, **regs, "nvidia_smi": smi})
    offsets = cs._resnet18_offsets()
    k, n = cs.K_MAIN, cs.N_MAIN
    for part in (True, False):
        gen = torch.Generator(device="cuda").manual_seed(11)
        x, scale, _, keys = cs._sr_inputs(gen, k, offsets, 3)
        q = sr_ops.int8_sr_quantize(x, scale, offsets, keys, part)
        cs.emit({"src": src, "digest_case": "resnet18", "K": k, "N": n,
                 "partitionable": part, "sha256_q": hashlib.sha256(
                     q.cpu().numpy().tobytes()).hexdigest()})
    clock_mhz = cs._max_sm_clock_mhz()
    int_per_s = cs.INT32_PER_CLOCK_PER_SM * cs.NUM_SMS * 1e6 * clock_mhz
    gen = torch.Generator(device="cuda").manual_seed(6)
    x, scale, _, keys = cs._sr_inputs(gen, k, offsets, 0)
    cases = [("whole stack", lambda: sr_ops.int8_sr_quantize(
        x, scale, offsets, keys), k, n, offsets.numel() - 1)]
    if "row0" in inspect.signature(sr_ops.int8_sr_quantize).parameters:
        from repro_torch.sharding.layout import ShardLayout
        shards = ShardLayout.from_sizes(
            cs.layout_of(cs._init(cs.paper_resnet18.CONFIG)),
            {"clients": 2, "model": 2})
        xs, ss = x[5:].contiguous(), scale[5:].contiguous()
        cases.append(("rows 5-9 of 10", lambda: sr_ops.int8_sr_quantize(
            xs, ss, offsets, keys, row0=5, rows_total=10), 5, n,
            offsets.numel() - 1))
        m = 1
        xm = shards.scatter(xs, m)
        ids = shards.leaf_ids(m)
        sm = ss[:, ids].contiguous()
        km = jax_prng.fold_in_many(jax_prng.fold_in(jax_prng.PRNGKey(0),
                                                    0), ids)
        block = {"row0": 5, "rows_total": 10,
                 "leaf_blocks": shards.leaf_blocks(m)}
        om = shards.offsets(m)
        cases.append(("model shard 1 of 2, rows 5-9 of 10",
                      lambda: sr_ops.int8_sr_quantize(xm, sm, om, km,
                                                      **block),
                      5, xm.shape[1], len(ids)))
    for name, call, kk, nn, nleaves in cases:
        nbytes, ops = cs._sr_bytes_ops(kk, nn, nleaves)
        b_ms, b_by = cs.bound_ms(nbytes, ops, flop_per_s=int_per_s)
        ms, ms_one = cs.cuda_ms(call)
        cs.emit({"src": src, "timing": "int8_sr_quantize", "case": name,
                 "K": kk, "N": nn, "ms": ms, "ms_one_call": ms_one,
                 "ms_cold_spin": cs.cuda_ms_cold(call, spin=True),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "pct_of_bound": 100.0 * b_ms / ms, "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
