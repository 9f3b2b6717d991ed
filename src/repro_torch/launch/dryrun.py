"""Multi-pod dry-run (counterpart of repro/launch/dryrun.py): every
(architecture x input shape x mesh) step of ONE rank of the production
meshes run to its end on meta tensors, with its roofline terms.

The reference lowers and compiles each step for 512 placeholder devices
and reads XLA's cost analysis. The port has no compiler: it runs rank
0's step eagerly on meta tensors (shapes and dtypes, no data, no memory)
over a fake process group of 256 or 512 ranks
(launch/mesh.make_production_mesh), and counts what the step does —
FLOPs, the bytes its ops and kernels read and write, the bytes of the
collectives it calls (roofline/analysis.py). "Compiles" here means
that step runs to its end; ``compile_=False`` builds the step and its
rank-local inputs only.

The steps are the port's own (launch/steps.py), one rank's:
  train    the tensor-parallel step over the mesh's model group on the
           data rank's rows of the batch, each gradient summed over the
           data group (pod x data on the multi-pod mesh): the collectives
           GSPMD puts in the reference's compiled train_4k. MoE layers
           run GShard's dispatch tensor-parallel (``moe_impl="gshard"``;
           the reference's ``_moe_shard_fn`` placement constraints have
           no eager meaning, so no ``shard_fn`` is passed) or the
           expert-parallel all-to-all (``"ep"``, experts over the data
           axes).
  prefill, decode
           the tensor-parallel serving step (``model_group=``) on the
           data rank's rows (``rules.batch_specs``: a batch the data axes
           do not divide, as long_500k's B = 1, is whole on the rank),
           its states cut to the rank (its KV heads, its d_inner
           channels), the last-position logits gathered whole over the
           model group, then over the data group where the rows were
           split (the reference's ``out_shardings=None``). Serving runs
           the hand-written kernels' meta routes (attention.sdpa "auto"
           and the Mamba mixer pick the kernels on meta as on the card).

Must run in a process of its own (the fake global group):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --table
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fl-round

``--table`` runs each step at one and at two groups of the layer stack
and extrapolates to the full depth (``roofline_table_entry``), as the
reference does for its scan; an eager count is linear in depth, so here
it only saves time (``roofline_table_entry`` says where it is not
exact). ``--unroll`` and ``scan_unroll`` are accepted and change
nothing: every layer is counted.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from repro_torch import bridge
from repro_torch.configs.base import all_arch_ids, get_config
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (make_production_mesh, mesh_info,
                                     production_data_group)
from repro_torch.models.layers import META
from repro_torch.roofline.analysis import (analyze_compiled, model_flops,
                                           roofline_report)
from repro_torch.sharding import tensor_parallel as tpm
from repro_torch.sharding.rules import ShardingPolicy, batch_specs, mesh_axes


def _ep_mesh(mesh):
    """A (data, model) DeviceMesh over the production mesh's ranks, the
    data axes flattened (32 x 16 on the multi-pod mesh): the expert-
    parallel step's (models/moe_ep.py)."""
    if "pod" not in mesh.mesh_dim_names:
        return mesh
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", mesh.mesh.reshape(-1, mesh.mesh.shape[-1]),
                      mesh_dim_names=("data", "model"))


def _rows(data: dict, mesh) -> dict:
    """The rank's rows of each input: dim 0 cut as ``rules.batch_specs``
    puts it over the data axes (rank 0's rows: the first B / S), whole
    where it replicates."""
    sizes = mesh_axes(mesh)
    out = {}
    for key, x in data.items():
        axes = batch_specs(x, mesh)[0]
        n = 1
        for a in (() if axes is None else axes if isinstance(axes, tuple)
                  else (axes,)):
            n *= sizes[a]
        out[key] = x[:x.shape[0] // n]
    return out


def build_step(cfg, shape, mesh, *, moe_impl: str = "gshard",
               step_kwargs: dict = None):
    """(step, args): rank 0's step of ``cfg`` at ``shape`` on ``mesh`` and
    its meta arguments (module docstring)."""
    kw = dict(step_kwargs or {})
    data_group = production_data_group(mesh)
    ep = cfg.moe and moe_impl == "ep"
    if ep:
        kw.update(moe_impl="ep", moe_mesh=_ep_mesh(mesh))
    else:
        kw["model_group"] = mesh["model"].get_group()
    dtype = getattr(torch, cfg.dtype)
    specs = steps_mod.input_specs(cfg, shape)
    if shape.kind == "train":
        if not ep:
            kw["data_group"] = data_group
        step = steps_mod.make_train_step(cfg, **kw)
        shard = torch.empty(step.view.size, dtype=dtype, device=META)
        return step, (shard, specs["batch"])

    make = (steps_mod.make_prefill_step if shape.kind == "prefill"
            else steps_mod.make_decode_step)
    step = make(cfg, shape, **kw)
    srv = step.serving
    leaves = bridge.tree_leaves(steps_mod.serving_spec(cfg))
    params = srv.params(lambda i: leaves[i])
    data = specs if ep else _rows(specs, mesh)
    rows = next(iter(data.values())).shape[0]
    split = rows < shape.global_batch and not ep
    cap = steps_mod.cache_capacity(cfg, shape)
    # an expert-parallel rank's states hold its rows of the whole batch
    states = srv.init_states(rows, cap, dtype, META)
    if cfg.is_encoder_decoder and shape.kind == "decode":
        states["enc_out"] = torch.empty(
            (rows, cfg.encoder_seq_len, cfg.d_model), dtype=dtype,
            device=META)
    if shape.kind == "prefill":
        order = (["frames", "tokens"] if cfg.is_encoder_decoder
                 else ["tokens"] + (["patch_embeds"]
                                    if "patch_embeds" in data else []))
    else:
        order = ["tokens", "positions"]
    dp = tpm.TPContext.of(data_group) if split else None

    def serve(params, states, *inputs):
        with torch.no_grad():
            new_states, logits = step(params, states, *inputs)
            return new_states, tpm.gather_from_region(logits, dp, 0)
    return serve, (params, states, *[data[k] for k in order])


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def lower_and_compile(arch: str, shape_name: str, *, multi_pod: bool = False,
                      compile_: bool = True, verbose: bool = True,
                      policy: ShardingPolicy = None,
                      step_kwargs: dict = None, unroll: bool = False,
                      cfg_override=None, moe_impl: str = "gshard"):
    """Rank 0's step of (arch, shape) on the production mesh, run to its
    end on meta tensors (``compile_``; else only built) -> its Roofline.
    ``policy`` and ``unroll`` are the reference's and change nothing
    here (the rank's rows follow the data axes, as the reference's
    default policy; every layer is counted)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = _mesh_name(multi_pod)
    chips = mesh_info(mesh)["num_devices"]
    step, args = build_step(cfg, shape, mesh, moe_impl=moe_impl,
                            step_kwargs=step_kwargs)
    if not compile_:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "lowered": True}
    rl = analyze_compiled(step, args, arch=arch, shape_name=shape_name,
                          mesh_name=mesh_name, chips=chips,
                          model_flops_total=model_flops(cfg, shape))
    if verbose:
        print(roofline_report(rl))
    return rl


def fl_round_dryrun(arch: str = "starcoder2-3b", *, algorithm: str = "feddpc",
                    multi_pod: bool = False, clients: int = None,
                    local_steps: int = 2, seq_len: int = 4096,
                    verbose: bool = True, cfg_override=None,
                    unroll: bool = False):
    """ONE cross-silo FL round (core/round.make_fl_round_step) of rank 0
    on a ("clients", "model") view of the production mesh — a client
    slice a row of the mesh, each silo a model-parallel replica, local
    training and then the FedDPC epilogue on the rank's parameter shard
    — run to its end on meta tensors. K = 16 (32 multi-pod) silos, 2
    local steps of 256 // (K·2) sequences of ``seq_len``. The round's
    local training runs under ``torch.func`` (core/client.py), which
    takes no checkpoint hooks, so its layers keep their activations
    (the reference's loss recomputes them: ``remat="full"``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.round import (fl_round_input_specs,
                                        make_fl_round_step)
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding.layout import ShardLayout

    cfg = cfg_override if cfg_override is not None else get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_info(mesh)["num_devices"]
    model = mesh_axes(mesh)["model"]
    view = DeviceMesh("cpu", mesh.mesh.reshape(-1, model),
                      mesh_dim_names=("clients", "model"))
    slices = chips // model
    n_clients = clients or slices
    if n_clients % slices:
        raise ValueError(f"{n_clients} silos over {slices} client slices")
    local_batch = max(1, 256 // (n_clients * local_steps))
    template = steps_mod.params_spec(cfg)
    layout = bridge.layout_of(template)
    step = make_fl_round_step(
        tfm.LMLoss(cfg), layout, eta_l=1e-2, eta_g=1e-2,
        algorithm=algorithm, mesh=view, params_template=template)
    shards = ShardLayout.from_mesh(layout, view)
    m = int(view.get_coordinate()[1])
    params = torch.empty(shards.sizes[m], dtype=torch.float32, device=META)
    delta = torch.empty_like(params)
    batch = fl_round_input_specs(cfg, clients=n_clients // slices,
                                 local_steps=local_steps,
                                 local_batch=local_batch, seq_len=seq_len)
    tokens = n_clients * local_steps * local_batch * seq_len
    mf = 6.0 * cfg.param_counts()["active"] * tokens
    rl = analyze_compiled(
        step, (params, delta, batch), arch=f"fl-round[{algorithm}]-{arch}",
        shape_name=f"K{n_clients}xM{local_steps}xB{local_batch}x{seq_len}",
        mesh_name=_mesh_name(multi_pod), chips=chips, model_flops_total=mf)
    if verbose:
        print(roofline_report(rl))
    return rl


def _depth_variant(cfg, groups: int):
    """cfg with the periodic stack reduced to `groups` groups (prefix kept)."""
    from repro_torch.models.transformer import stack_plan
    if cfg.is_encoder_decoder:
        return cfg.with_(num_layers=groups, encoder_layers=groups)
    prefix, period, _ = stack_plan(cfg)
    return cfg.with_(num_layers=prefix + period * groups)


def _groups(cfg) -> int:
    from repro_torch.models.transformer import stack_plan
    return cfg.num_layers if cfg.is_encoder_decoder else stack_plan(cfg)[2]


def roofline_table_entry(arch: str, shape_name: str, *, multi_pod: bool = False,
                         verbose: bool = True, policy=None,
                         step_kwargs: dict = None, moe_impl: str = "gshard"):
    """The roofline by DEPTH DIFFERENCING, as the reference's: the step
    at one and at two groups of the layer stack (prefix + 1·period and
    prefix + 2·period layers; an encoder-decoder's encoder and decoder
    both), extrapolated linearly to the G groups of the full depth,

        X_total = X(d1) + (G-1) · (X(d2) - X(d1))

    for FLOPs, bytes, each collective kind and the memory per device.
    The reference needs it because XLA counts a scan's body once; an
    eager count is linear in depth, so here it only saves time: equal to
    the full-depth run (the tests hold dense, hybrid and Mamba steps to
    it) wherever the variants keep the full model's stack plan. The
    reference's ``stack_plan`` lays out DeepSeek-V2's and Kimi-K2's
    variants (a dense layer, then one or two MoE layers) as one group
    of every layer, not as the full model's dense prefix and stack, so
    their train steps' bytes read 2–3e-6 off the full-depth count (the
    dense layer's gradient passes the stack's unbind once more); their
    FLOPs, collectives and memory are equal. A stack of at most two
    groups runs whole."""
    cfg = get_config(arch)
    groups = _groups(cfg)
    kw = dict(multi_pod=multi_pod, verbose=False, policy=policy,
              step_kwargs=step_kwargs, moe_impl=moe_impl)
    if groups <= 2:
        full = lower_and_compile(arch, shape_name, **kw)
    else:
        f1, f2 = (lower_and_compile(arch, shape_name,
                                    cfg_override=_depth_variant(cfg, g),
                                    **kw) for g in (1, 2))
        scale = groups - 1
        ext = lambda a, b: a + scale * (b - a)
        full = f1
        full.flops = ext(f1.flops, f2.flops)
        full.hbm_bytes = ext(f1.hbm_bytes, f2.hbm_bytes)
        full.memory_per_device = ext(f1.memory_per_device,
                                     f2.memory_per_device)
        full.coll_bytes = {k: int(ext(f1.coll_bytes[k], f2.coll_bytes[k]))
                           for k in f1.coll_bytes}
        full.count = None
    if verbose:
        print(roofline_report(full))
    return full


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="write JSON results here")
    ap.add_argument("--lower-only", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="the reference's; every layer is counted anyway")
    ap.add_argument("--table", action="store_true",
                    help="depth-differencing roofline (fast; equal to the "
                         "full-depth count but for DeepSeek-V2's and "
                         "Kimi-K2's train bytes, 2-3e-6 off)")
    ap.add_argument("--fl-round", action="store_true",
                    help="run the cross-silo FL ROUND step instead")
    ap.add_argument("--algorithm", default="feddpc")
    ap.add_argument("--moe-impl", default="gshard", choices=["gshard", "ep"])
    args = ap.parse_args(argv)

    if args.fl_round:
        rl = fl_round_dryrun(args.arch or "starcoder2-3b",
                             algorithm=args.algorithm,
                             multi_pod=args.mesh == "multi")
        if args.out:
            with open(args.out, "w") as f:
                json.dump([rl.as_dict()], f, indent=1)
        return 0

    archs = all_arch_ids() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results, failures = [], []
    for multi in meshes:
        for arch in archs:
            for shape_name in shapes:
                tag = f"{arch} x {shape_name} x " + _mesh_name(multi)
                t0 = time.time()
                try:
                    if args.table:
                        rl = roofline_table_entry(arch, shape_name,
                                                  multi_pod=multi,
                                                  moe_impl=args.moe_impl)
                    else:
                        rl = lower_and_compile(
                            arch, shape_name, multi_pod=multi,
                            compile_=not args.lower_only, unroll=args.unroll,
                            moe_impl=args.moe_impl)
                    dt = time.time() - t0
                    print(f"[OK]   {tag}  ({dt:.1f}s)")
                    if hasattr(rl, "as_dict"):
                        results.append(rl.as_dict())
                except Exception as e:
                    dt = time.time() - t0
                    print(f"[FAIL] {tag}  ({dt:.1f}s): "
                          f"{type(e).__name__}: {e}")
                    traceback.print_exc()
                    failures.append(tag)
    print(f"\n{len(results)} OK, {len(failures)} failed")
    if failures:
        for f in failures:
            print("  FAILED:", f)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
