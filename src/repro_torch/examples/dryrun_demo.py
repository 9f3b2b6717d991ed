"""Multi-pod dry-run demo (counterpart of examples/dryrun_demo.py): one
(arch x shape) step of one rank of the production mesh run to its end
on meta tensors, with its roofline terms against an H100 — no card
needed.

  PYTHONPATH=src python -m repro_torch.examples.dryrun_demo \\
      --arch deepseek-v2-236b --shape prefill_32k --multi-pod

It must run as a process of its own (the dry-run starts a fake global
process group of 256 or 512 ranks: launch/mesh.make_production_mesh),
which is why this demo shells into ``repro_torch.launch.dryrun``.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", args.arch, "--shape", args.shape,
           "--mesh", "multi" if args.multi_pod else "single", "--table"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    print("+", " ".join(cmd), flush=True)
    return subprocess.call(cmd, env=env)


if __name__ == "__main__":
    raise SystemExit(main())
