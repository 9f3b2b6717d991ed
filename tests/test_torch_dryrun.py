"""The port's dry-run (repro_torch/launch/dryrun.py): one rank's step of
every (arch x shape x mesh) run to its end on meta tensors over a fake
256- and 512-rank process group, with its roofline counts.

The fake global group must not live in a pytest worker (it would break
make_debug_mesh's one-process mesh for every later test file there), so
one subprocess (tests/_torch_dryrun_worker.py) runs every dry-run and
dumps its counts; these tests read them:

  * every (arch x shape) of both meshes at ``_depth_variant(cfg, 1)``
    runs to its end with nonzero FLOPs, bytes and collective bytes (each
    has M = 16 model ranks), serving through the kernels' meta routes;
  * depth differencing (``roofline_table_entry``) equals the full-depth
    count exactly for a dense decode, the hybrid's decode and a Mamba
    train step (the plain scan's counted op, remat, the data-axis sums);
  * minitron-8b decode_32k on (16, 16): FLOPs and collective bytes equal
    a count by hand from the config;
  * the FL round at depth 1 runs local training and both FedDPC kernels'
    meta routes;
  * the production mesh refuses a real job's group.
"""
import json
import os
import subprocess
import sys

import pytest

import _torch_dryrun_worker as w
from repro_torch.configs.base import all_arch_ids, get_config
from repro_torch.configs.shapes import SHAPES
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dryrun_worker.py")
MESHES = ("pod16x16", "pod2x16x16")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun") / "dryrun.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, WORKER, out], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "TORCH_DRYRUN_WORKER_OK" in proc.stdout
    with open(out) as fh:
        return json.load(fh)


def _row(runs, mesh, arch, shape):
    return next(r for r in runs["all"] if (r["mesh"], r["arch"], r["shape"])
                == (mesh, arch, shape))


@pytest.mark.parametrize("mesh", MESHES)
def test_every_combination_runs_at_depth_one(runs, mesh):
    """The 40 (arch x shape) steps of a mesh all ran to their end, each
    with FLOPs, bytes and collective bytes (every arch has model-axis
    sums at M = 16) and a memory bound."""
    rows = [r for r in runs["all"] if r["mesh"] == mesh]
    assert sorted((r["arch"], r["shape"]) for r in rows) == sorted(
        (a, s) for a in all_arch_ids() for s in SHAPES)
    for r in rows:
        assert r["flops"] > 0 and r["bytes"] > 0, r
        assert sum(r["coll"].values()) > 0, r
        assert r["memory"] > 0 and r["model_flops"] > 0, r
        assert r["dominant"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("mesh", MESHES)
def test_serving_steps_take_the_kernels_meta_routes(runs, mesh):
    """Serving on meta takes the card's route: every attention prefill
    records flash_attention (MLA's too), every GQA decode and SSM step
    its kernel (MLA's absorbed decode none); training records none of
    the serving kernels, and a Mamba train step the plain scan's counted
    op, forward and backward."""
    for arch in all_arch_ids():
        cfg = get_config(arch)
        ssm = cfg.arch_type in ("ssm", "hybrid")
        attn = cfg.attention != "none"
        for shape in SHAPES:
            got = set(_row(runs, mesh, arch, shape)["kernels"])
            if shape == "train_4k":
                want = ({"ssm_scan_ref", "ssm_scan_ref backward"} if ssm
                        else set())
            else:
                want = {"ssm_scan"} if ssm else set()
                if attn and (shape == "prefill_32k"
                             or cfg.attention == "gqa"):
                    want.add("flash_attention")
            assert got == want, (arch, shape, got)


def test_the_multi_pod_mesh_halves_a_train_steps_rows(runs):
    """train_4k's 256 rows over 16 data ranks, then over pod x data's
    32: a rank's FLOPs halve (its rows do; the parameter work is the
    same), its gradient sums stay one all-reduce of its shard a block."""
    for arch in ("minitron-8b", "starcoder2-3b"):
        one = _row(runs, "pod16x16", arch, "train_4k")
        two = _row(runs, "pod2x16x16", arch, "train_4k")
        assert 0.45 < two["flops"] / one["flops"] < 0.55, arch
        assert one["memory"] == two["memory"]


@pytest.mark.parametrize("arch,shape", w.EXACT)
def test_depth_differencing_equals_the_full_depth_count(runs, arch, shape):
    """``roofline_table_entry``'s extrapolation from one and two groups
    of the layer stack equals the full-depth run exactly: FLOPs, bytes,
    every collective kind and the memory bound."""
    run = next(e for e in runs["exact"]
               if (e["full"]["arch"], e["full"]["shape"]) == (arch, shape))
    full, table = run["full"], run["table"]
    for key in ("flops", "bytes", "coll", "memory"):
        assert full[key] == table[key], (key, full[key], table[key])


def test_a_dense_decode_matches_a_count_by_hand(runs):
    """minitron-8b decode_32k on (16, 16), full depth: rank 0 holds 8 of
    the 128 rows (128 / 16 data ranks) and 2 of the 32 query heads,
    which read one KV head (32 / 8 = 4 query heads a KV head); its 1/16
    of the relu2 MLP's 16,384 and of the 256,000-token head. FLOPs: the
    projections' 2·m·n·k, the flash kernel's 4·D FLOPs a (head, key)
    pair over the 32,768 slots. Collectives: two f32 sums of (8, 1, 4096)
    a layer (after wo and down; bf16 partials sum in f32), the
    vocab-parallel lookup's bf16 sum, the logits' all-gather over the
    model group, then over the data group (the reference's
    out_shardings=None)."""
    cfg = get_config("minitron-8b")
    model, data = 16, 16
    b = 128 // data
    d, hd = cfg.d_model, cfg.resolved_head_dim
    heads, kv = cfg.num_heads // model, 1
    f, v = cfg.d_ff // model, cfg.vocab_size // model
    cap = 32_768
    layer = (2 * b * d * heads * hd + 2 * 2 * b * d * kv * hd
             + 2 * b * heads * hd * d + 4 * hd * heads * b * cap
             + 2 * 2 * b * d * f)
    flops = cfg.num_layers * layer + 2 * b * d * v
    hand = runs["hand"]
    assert hand["flops"] == flops
    assert hand["coll"] == {
        "all-reduce": cfg.num_layers * 2 * b * d * 4 + b * d * 2,
        "all-gather": b * cfg.vocab_size * 2 + 128 * cfg.vocab_size * 2,
        "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
    assert [k[0] for k in hand["kernel_calls"]] == \
        ["flash_attention"] * cfg.num_layers
    assert all(k[1] == 4 * hd * heads * b * cap
               for k in hand["kernel_calls"])


def test_the_fl_round_runs_at_depth_one(runs):
    """One cross-silo FedDPC round of StarCoder2-3B at one layer on the
    (16 x 16) clients x model view: local training of the rank's silo
    on its shard, then one feddpc_dots and one feddpc_batched_epilogue
    meta launch on its N_m columns."""
    fl = runs["fl_round"]
    assert fl["arch"] == "fl-round[feddpc]-starcoder2-3b"
    assert fl["shape"] == "K16xM2xB8x4096"
    assert [k[0] for k in fl["kernel_calls"]] == ["feddpc_dots",
                                                  "feddpc_batched_epilogue"]
    assert fl["flops"] > 0 and sum(fl["coll"].values()) > 0


def test_the_production_mesh_refuses_a_real_group(runs):
    assert "a real job's process group is up (gloo)" in runs["refuses"]
