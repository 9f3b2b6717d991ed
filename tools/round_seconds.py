"""Seconds per round of chip_smoke.py's trainer runs, for one checkout's
port: the smoke's trainer phase as it stands (ResNet18-GN at full width,
the same runs, cohorts and per-round launch checks; its lines printed as
they come), then one summary line with each run's median round seconds
after round 0.

``--src DIR`` takes the port from DIR/src — an older commit unpacked there
— while the runs stay this checkout's, so two versions of the port meet
the same runs. A card's round times drift from call to call, so compare
two trees only within one call, in turns (A B B A ...). Needs the card:

    python3 tools/round_seconds.py [--src DIR]
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser()
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
        print("round_seconds: CUDA is not available; this tool needs a card",
              file=sys.stderr)
        return 1
    medians = {}
    emit = cs.emit

    def collect(obj):
        if "median_seconds_after_0" in obj:
            medians[obj["run"]] = obj["median_seconds_after_0"]
        emit(obj)

    cs.emit = collect
    launches = cs.phase_trainer()
    emit({"src": src, "card": cs._smi("name,power.limit"),
          "launches": launches, "median_seconds_after_0": medians})
    return 0


if __name__ == "__main__":
    sys.exit(main())
