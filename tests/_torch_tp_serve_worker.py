"""One rank of the port's tensor-parallel serving check
(tests/test_torch_tp_serve.py), spawned on gloo by
launch/distributed.spawn_local in a job of PAIR or QUAD ranks. Imports
neither JAX nor the reference; importing it joins no job (the test
process reads its constants and builders).

Every rank of a job of M ranks serves each family of CASES at its SMOKE
size over the job as one model group: launch/steps.make_prefill_step
and make_decode_step with ``model_group=``, on params cut from the
reference's init (core/jax_prng, the serving tree's leaves) and on the
same numpy prompts as the test process: a prefill of PROMPT tokens, then
EXTRA teacher-forced decode steps. It dumps the whole logits of every
step and the gathered states after the prefill and after the last step,
and records whether the params cut from its shard equal those cut from
whole leaves, the collectives of each decode step and its cache bytes.
The QUAD job also serves EP_CASE with ``moe_impl="ep"`` on a (2 x 2)
make_debug_mesh at capacity factor EP_CF.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

SEED = 0
PAIR, QUAD = 2, 4
B, PROMPT, EXTRA = 4, 12, 3
# case -> arch, at its SMOKE size: one of each family
CASES = {"starcoder2": "starcoder2-3b",            # dense GQA
         "deepseek": "deepseek-v2-236b",           # MLA + MoE
         "falcon_mamba": "falcon-mamba-7b",        # SSM
         "jamba": "jamba-1.5-large-398b",          # hybrid + MoE
         "llava": "llava-next-mistral-7b",         # VLM trunk
         "whisper": "whisper-base"}                # encoder-decoder
EP_CASE, EP_CF = "deepseek", 8.0


def case_config(case, get_config, ep=False):
    """The SMOKE config of a case, from ``get_config`` (either package's);
    ``ep``: at the expert-parallel form's capacity factor."""
    cfg = get_config(CASES[case], smoke=True)
    return cfg.with_(capacity_factor=EP_CF) if ep else cfg


def inputs(cfg):
    """The prompts (B, PROMPT), the EXTRA forced tokens (B, 1) each, and a
    VLM's patch embeddings or an encoder-decoder's frames, from a numpy
    seed."""
    rng = np.random.RandomState(11)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (B, PROMPT)
                                 ).astype(np.int32),
           "forced": rng.randint(0, cfg.vocab_size, (EXTRA, B, 1)
                                 ).astype(np.int32)}
    if cfg.modality == "vision":
        out["patch_embeds"] = rng.randn(B, cfg.num_patches,
                                        cfg.d_model).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.randn(B, cfg.encoder_seq_len,
                                  cfg.d_model).astype(np.float32)
    return out


def prefix(cfg):
    """The positions before the prompt: a VLM's patches."""
    return cfg.num_patches if cfg.modality == "vision" else 0


def capacity(cfg):
    return prefix(cfg) + PROMPT + EXTRA


def flat_states(states, stage):
    """{"<stage>/<layer>/<key>": array} of a port states tree (the LM's
    per-layer list, or an encoder-decoder's {"decoder": [...],
    "enc_out"}); ``idx`` as a 0-d array. Copies: a cache is written in
    place by the next step."""
    out = {}
    layers = states["decoder"] if isinstance(states, dict) else states
    for j, layer in enumerate(layers):
        for key, x in layer.items():
            out[f"{stage}/{j}/{key}"] = np.array(
                x.numpy() if torch.is_tensor(x) else x)
    if isinstance(states, dict) and "enc_out" in states:
        out[f"{stage}/enc_out"] = np.array(states["enc_out"].numpy())
    return out


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def serve(cfg, rank, out, tag, **step_kw):
    """Prefill + EXTRA decode steps of ``cfg`` over the job (the steps'
    ``step_kw``); dumps ``tag``_r``rank``.npz/.json."""
    from repro_torch import bridge
    from repro_torch.configs import shapes
    from repro_torch.core import jax_prng
    from repro_torch.launch import steps
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tf
    prefill = steps.make_prefill_step(cfg, shapes.SHAPES["prefill_32k"],
                                      **step_kw)
    decode = steps.make_decode_step(cfg, shapes.SHAPES["decode_32k"],
                                    **step_kw)
    log = []
    for srv in (prefill.serving, decode.serving):
        for ctx in (srv.tp, srv.ep):
            if ctx is not None:
                ctx.timer = lambda name, x, run: (log.append(name), run())
    init = encdec.init_encdec if cfg.is_encoder_decoder else tf.init_lm
    tree = steps.serving_tree(cfg, init(cfg, jax_prng.PRNGKey(SEED),
                                        torch.float32))
    leaves = bridge.tree_leaves(tree)
    srv = prefill.serving
    with torch.inference_mode():
        params = srv.params(lambda i: leaves[i])
        # the same params cut from the rank's shard (a gather a leaf)
        shards = srv.view.shards
        flat = bridge.layout_of(tree).flatten(tree)
        from_shard = srv.params(shards.scatter(flat, srv.view.r))
        same = all(torch.equal(a, b) for a, b in zip(
            bridge.tree_leaves(params), bridge.tree_leaves(from_shard)))
        del from_shard
        data = inputs(cfg)
        states = srv.init_states(B, capacity(cfg), torch.float32, "cpu")
        cache_bytes = sum(x.numel() * x.element_size() for x in
                          bridge.tree_leaves(states) if torch.is_tensor(x))
        if cfg.is_encoder_decoder:
            states, logits = prefill(params, states, _t(data["frames"]),
                                     _t(data["tokens"]))
        else:
            embeds = (_t(data["patch_embeds"]) if "patch_embeds" in data
                      else None)
            states, logits = prefill(params, states, _t(data["tokens"]),
                                     embeds)
        arrays = {"logits_0": logits.numpy(),
                  **flat_states(srv.gather_states(states), "prefill")}
        per_step = []
        for i in range(EXTRA):
            pos = np.full((B, 1), prefix(cfg) + PROMPT + i, np.int32)
            del log[:]
            states, logits = decode(params, states, _t(data["forced"][i]),
                                    _t(pos))
            per_step.append(list(log))
            arrays[f"logits_{i + 1}"] = logits.numpy()
        arrays.update(flat_states(srv.gather_states(states), "last"))
    np.savez(os.path.join(out, f"{tag}_r{rank}.npz"), **arrays)
    with open(os.path.join(out, f"{tag}_r{rank}.json"), "w") as fh:
        json.dump({"params_from_shard_equal": same,
                   "decode_collectives": per_step,
                   "cache_bytes": cache_bytes}, fh)


def main():
    from repro_torch.configs.base import get_config
    from repro_torch.launch import distributed
    ctx = distributed.maybe_initialize()
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    ranks, rank = ctx.num_processes, ctx.process_id
    assert ranks in (PAIR, QUAD), ctx
    import torch.distributed as dist
    from repro_torch.launch import mesh
    for case in CASES:
        serve(case_config(case, get_config), rank, args.out,
              f"{case}{ranks}", model_group=dist.group.WORLD)
    if ranks == QUAD:
        serve(case_config(EP_CASE, get_config, ep=True), rank, args.out,
              "ep", moe_impl="ep", moe_mesh=mesh.make_debug_mesh(2, 2))
    print("TORCH_TP_SERVE_WORKER_OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
