"""Seconds per round of chip_smoke.py's trainer runs, for one checkout:
its smoke's trainer phase (ResNet18-GN at full width, the runs, cohorts
and per-round launch checks; its lines printed as they come), then each
of the phase's runs built afresh and driven once through ``run()``, and
one summary line with each run's median round seconds after round 0,
its seconds per round and its ``run()`` wall seconds per round. The
wall time runs from the call to its return, every round included (round
0 too) with its every-round eval: inline in a tree that evaluates on the
round's thread, landed by ``run()``'s own finalize in one that evaluates
asynchronously. It is the number a user of the trainer waits for.

``--src DIR`` runs the checkout unpacked in DIR (an older commit): its
port and its own chip_smoke.py's trainer phase, so each tree runs the
regime its defaults define, and the runs both trees hold compare one to
one. A card's round times drift from call to call, so compare two trees
only within one call, in turns (A B B A ...). Needs the card:

    python3 tools/round_seconds.py [--src DIR]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_walls(cs, torch) -> dict:
    """Each run of ``cs.RUNS``, built as its trainer phase builds it and
    driven once through ``run()``: wall seconds over its rounds."""
    cfg = cs.paper_resnet18.CONFIG
    data, source, loss_fn = cs._image_task(cfg, 100, 50, 10)
    params = (cs._init(cfg) if hasattr(cs, "_init")     # the reference's draw
              else cs.init_vision(cfg, torch.Generator().manual_seed(0)))
    walls = {}
    for label, name, exec_kw, exp, rounds, _, plan_kw in cs.RUNS:
        plan = (None if plan_kw is None
                else cs.FaultPlan.seeded(cs.PLAN_SEED, **plan_kw))
        trainer = cs._trainer(cfg, data, source, loss_fn, params, name,
                              rounds, "cuda", exec_kw,
                              cs.ExponentialRuntime(mean=1.0) if exp
                              else None, plan,
                              cs.SAMPLERS.get(label, lambda: None)())
        torch.cuda.synchronize()
        tic = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        walls[label] = (time.perf_counter() - tic) / rounds
        if hasattr(trainer, "close"):      # a tree with a staging thread
            trainer.close()
        del trainer
        cs.emit({"run": label, "rounds": rounds,
                 "run_wall_seconds_per_round": walls[label]})
    return walls


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", default=ROOT,
                        help="checkout whose src/repro_torch is measured")
    args = parser.parse_args()
    src = os.path.join(os.path.abspath(args.src), "src")
    sys.path.insert(0, src)
    import repro_torch  # noqa: F401  (chip_smoke's imports resolve here)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("round_seconds: CUDA is not available; this tool needs a card",
              file=sys.stderr)
        return 1
    medians, rounds = {}, {}
    emit = cs.emit

    def collect(obj):
        if "median_seconds_after_0" in obj:
            medians[obj["run"]] = obj["median_seconds_after_0"]
            rounds[obj["run"]] = obj["seconds_per_round_after_0"]
        emit(obj)

    cs.emit = collect
    launches = cs.phase_trainer()
    walls = run_walls(cs, torch)
    emit({"src": src, "card": cs._smi("name,power.limit"),
          "launches": launches, "median_seconds_after_0": medians,
          "seconds_per_round_after_0": rounds,
          "run_wall_seconds_per_round": walls})
    return 0


if __name__ == "__main__":
    sys.exit(main())
