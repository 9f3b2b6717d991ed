"""What chip_smoke.py's model_axis codec gate reads when the codec's
shard arguments are wrong: model-axis run (d) (int8_sr on the
(clients, model) mesh) with int8_sr drawn as if each rank's block were
the whole stack (no row0, rows_total or leaf blocks), and run (b) (int8)
with each shard quantized by its own extrema instead of the whole
leaf's. Each faulted run is read as the phase reads it — its losses and
params against this process's one-process run, relative to max|w| —
beside the same run without the fault, and beside the gate
(chip_smoke.MA_CODEC_RTOL), which this tool only reads.

The faults are injected into the ranks at run time (they replace
RankShard.leaf_extrema, and the codec's view of int8_sr_quantize, in the
rank's process); no code is changed. Needs the card (2 gloo ranks on one card,
ma_layout's NCCL ranks on more):

    python3 tools/codec_gate_reading.py
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

WORKER = "--worker"
# label -> (model_axis run, fault or None)
READINGS = {"b": ("b", None), "b_own_extrema": ("b", "own_extrema"),
            "d": ("d", None), "d_no_block_args": ("d", "no_block_args")}


@contextlib.contextmanager
def _fault(fault):
    """What the fault breaks replaced in this process, for the block."""
    if fault == "own_extrema":
        from repro_torch.core import round as round_mod
        owner, name = round_mod._Collectives, "leaf_extrema"
        broken = lambda self, mn, mx: (mn, mx)
    elif fault == "no_block_args":
        # the codec's view of the kernel's module, whose wrapper is kept
        import types
        from repro_torch.codec import codecs as owner
        name, quantize = "sr_ops", owner.sr_ops.int8_sr_quantize
        broken = types.SimpleNamespace(
            int8_sr_quantize=lambda x, scale, offsets, keys, **_:
            quantize(x, scale, offsets, keys))
    else:
        yield
        return
    kept = getattr(owner, name)
    setattr(owner, name, broken)
    try:
        yield
    finally:
        setattr(owner, name, kept)


def worker(out: str) -> int:
    import torch
    import chip_smoke as cs
    ctx = cs.distributed.maybe_initialize()
    torch.backends.cudnn.deterministic = True
    task = cs._mr_task()
    for label, (run, fault) in READINGS.items():
        with _fault(fault), cs._ma_trainer(task, cs.MA_RUNS[run][0],
                                           cs.MA_MODEL) as tr:
            tr.run()
            full = tr.full_params()
        if ctx.process_id == 0:
            torch.save({"params": full.cpu(),
                        "losses": [r.train_loss for r in tr.history]},
                       os.path.join(out, f"{label}.pt"))
        del tr, full
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == WORKER:
        return worker(sys.argv[2])
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("codec_gate_reading: CUDA is not available; this tool needs "
              "a card", file=sys.stderr)
        return 1
    ranks, backend = cs.ma_layout(torch.cuda.device_count())
    tic = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    task = cs._mr_task()
    single = {}
    for run in ("b", "d"):
        with cs._ma_trainer(task, cs.MA_RUNS[run][0], None) as tr:
            tr.run()
        single[run] = ([r.train_loss for r in tr.history], tr.flat.cpu())
        del tr
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="codec_gate_") as out:
        env = ({"NCCL_SOCKET_IFNAME": os.environ.get("NCCL_SOCKET_IFNAME",
                                                     "lo")}
               if backend == "nccl" else {})
        cs.distributed.spawn_local(
            [sys.executable, os.path.abspath(__file__), WORKER, out], ranks,
            backend=backend, local_devices=1 if backend == "gloo" else None,
            env=env, timeout_s=600)
        got = {label: torch.load(os.path.join(out, f"{label}.pt"))
               for label in READINGS}
    line = {"tool": "codec_gate_reading", "ranks": ranks,
            "backend": backend, "gate": cs.MA_CODEC_RTOL,
            "card": cs._smi("name,power.limit")}
    for label, (run, fault) in READINGS.items():
        want_losses, want = single[run]
        g = got[label]
        rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"],
                                                       want_losses))
        err = float((g["params"] - want).abs().max()) / float(
            want.abs().max())
        line[label] = {"fault": fault, "loss_max_rel": rel,
                       "params_max_rel": err,
                       "passes_gate": rel <= cs.MA_CODEC_RTOL
                       and err <= cs.MA_CODEC_RTOL}
    line["seconds"] = time.perf_counter() - tic
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
