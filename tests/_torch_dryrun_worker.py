"""The port's dry-run in a process of its own (tests/test_torch_dryrun.py):
launch/mesh.make_production_mesh starts a fake global process group of
256 or 512 ranks, which must not live in a pytest worker. Imports
neither JAX nor the reference.

    python tests/_torch_dryrun_worker.py OUT.json

writes {"all": [one row a (mesh, arch, shape) at depth 1], "exact":
[...], "hand": {...}, "fl_round": {...}, "refuses": "..."}: every
(arch x shape) of both meshes at ``_depth_variant(cfg, 1)``; EXACT's
combinations at full depth and by depth differencing; HAND's at full
depth with its count by kind; one FL round at depth 1; and the error
make_production_mesh raises under a real (gloo) group.
"""
import json
import os
import sys

EXACT = (("minitron-8b", "decode_32k"), ("jamba-1.5-large-398b",
                                          "decode_32k"),
         ("falcon-mamba-7b", "train_4k"))
HAND = ("minitron-8b", "decode_32k")


def _row(rl, mesh, arch, shape):
    return {"mesh": mesh, "arch": arch, "shape": shape,
            "flops": rl.flops, "bytes": rl.hbm_bytes,
            "coll": rl.coll_bytes, "memory": rl.memory_per_device,
            "dominant": rl.dominant, "model_flops": rl.model_flops_total,
            "kernels": sorted({k[0] for k in rl.count.kernels})
            if getattr(rl, "count", None) else None}


def main(out):
    from repro_torch.configs.base import all_arch_ids, get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun
    res = {"all": [], "exact": []}
    for multi in (False, True):
        for arch in all_arch_ids():
            cfg = dryrun._depth_variant(get_config(arch), 1)
            for shape in SHAPES:
                rl = dryrun.lower_and_compile(arch, shape, multi_pod=multi,
                                              cfg_override=cfg,
                                              verbose=False)
                res["all"].append(_row(rl, rl.mesh, arch, shape))
    for arch, shape in EXACT:
        full = dryrun.lower_and_compile(arch, shape, verbose=False)
        table = dryrun.roofline_table_entry(arch, shape, verbose=False)
        res["exact"].append({"full": _row(full, full.mesh, arch, shape),
                             "table": _row(table, table.mesh, arch, shape)})
    rl = dryrun.lower_and_compile(*HAND, verbose=False)
    res["hand"] = {**_row(rl, rl.mesh, *HAND),
                   "collectives": rl.count.collectives,
                   "kernel_calls": [list(k) for k in rl.count.kernels]}
    cfg = dryrun._depth_variant(get_config("starcoder2-3b"), 1)
    rl = dryrun.fl_round_dryrun("starcoder2-3b", cfg_override=cfg,
                                verbose=False)
    res["fl_round"] = {**_row(rl, rl.mesh, rl.arch, rl.shape),
                       "kernel_calls": [list(k) for k in rl.count.kernels]}

    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh_mod.make_production_mesh()
        res["refuses"] = None
    except RuntimeError as e:
        res["refuses"] = str(e)
    dist.destroy_process_group()
    with open(out, "w") as fh:
        json.dump(res, fh)
    print("TORCH_DRYRUN_WORKER_OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main(sys.argv[1])
