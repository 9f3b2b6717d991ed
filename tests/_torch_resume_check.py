"""Checkpoint/resume cases for the port (tests/test_torch_resume.py,
test_torch_checkpoint.py, test_torch_health.py), at the size of the
reference's own resume check (tests/_resume_check.py): a least-squares
model, 8 clients, 3 a round, ragged per-client batch counts.

``port_trainer(name)`` and ``ref_trainer(name)`` build one case in either
package from the same arguments, so a checkpoint one writes can be
resumed by the other. CASES: the five configs of tests/_resume_check.py
(6 rounds cut at 3, Markov sampler) and the mid-buffer async cuts of the
reference's test_async.py, test_codec.py, test_faults.py and
test_optim.py (concurrency above one wave, so entries are in flight at
the cut).

As a script it is the crash-and-requeue body: each phase a fresh
process (``full`` runs uninterrupted, ``part`` runs to the cut and
saves, ``resume`` resumes and runs to the end; full and resume dump
their finals to <workdir>/<phase>.npz):

    python tests/_torch_resume_check.py <phase> <workdir> <case>
"""
import os
import sys

import numpy as np
import torch

NUM_CLIENTS = 8
K = 3

_MARKOV_RT = ("MarkovRuntime", dict(num_clients=NUM_CLIENTS, fast=0.5,
                                    slow=3.0, p_slow=0.4, p_fast=0.5,
                                    dropout=0.1))
_EXP_RT = ("ExponentialRuntime", dict(mean=0.7))
_ASYNC = dict(async_buffer=True, buffer_size=2, async_concurrency=3)
_QPLAN = dict(nan_rate=0.5, nan_rounds=(1,), explode_rate=0.5,
              explode_rounds=(2,))

# name -> (algorithm, ExecConfig overrides, FaultPlan.seeded kwargs (seed
# 7) or None, runtime (class name, kwargs) or None, Markov sampler?,
# rounds, cut)
CASES = {
    # tests/_resume_check.py
    "feddpc": ("feddpc", {}, None, None, True, 6, 3),
    "fedvarp": ("fedvarp", {}, None, None, True, 6, 3),
    "fedexp": ("fedexp", {}, None, None, True, 6, 3),
    "feddpc_guarded": ("feddpc", dict(guard=True, guard_min_history=1),
                       dict(nan_rate=0.5, nan_rounds=(1, 4)), None, True,
                       6, 3),
    "feddpc_fedadam": ("feddpc", dict(server_opt="fedadam", health=True,
                                      health_window=4,
                                      health_min_history=2),
                       None, None, True, 6, 3),
    # mid-buffer async cuts: test_async.py, test_codec.py (int8 + error
    # feedback), test_faults.py (guarded, faults firing), test_optim.py
    "async_markov": ("feddpc", dict(_ASYNC), None, _MARKOV_RT, False, 6, 3),
    "async_int8_ef": ("feddpc", dict(_ASYNC, codec="int8", codec_ef=True),
                      None, _MARKOV_RT, False, 6, 3),
    "async_guarded": ("feddpc", dict(guard=True, guard_min_history=1,
                                     async_buffer=True,
                                     async_concurrency=2),
                      _QPLAN, _EXP_RT, False, 4, 2),
    "async_fedyogi": ("feddpc", dict(server_opt="fedyogi", async_buffer=True,
                                     async_concurrency=2, buffer_size=2),
                      None, None, False, 6, 3),
    # a cross-package case: FedVARP's table under Markov availability
    # and a FedAdam server step
    "fedvarp_fedadam": ("fedvarp", dict(server_opt="fedadam"), None, None,
                        True, 6, 3),
}


def make_params(seed=0):
    r = np.random.RandomState(seed)
    return {"w": r.randn(4, 3).astype(np.float32),
            "b": r.randn(3).astype(np.float32)}


def ragged_batch_fn(c, t):
    r = np.random.RandomState(1000 * c + t)
    return [{"x": r.randn(8, 4).astype(np.float32),
             "y": r.randn(8, 3).astype(np.float32)}
            for _ in range((c % 3) + 1)]


def port_loss(p, batch):
    pred = batch["x"] @ p["w"] + p["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _args(name, pkg, exec_kw=None, **over):
    """(ExecConfig, FederatedTrainer kwargs) of case ``name`` in the
    port ("port") or the reference ("ref"); ``exec_kw`` overrides the
    case's ExecConfig fields."""
    if pkg == "port":
        from repro_torch.core import api, runtime, samplers
        from repro_torch.core.faults import FaultPlan
    else:
        from repro.core import api, runtime, samplers
        from repro.core.faults import FaultPlan
    algo, kw, plan, rt, markov, rounds, _ = CASES[name]
    kw = {**kw, **(exec_kw or {})}
    if pkg == "ref":
        # blocking staging in the reference, as the port stages
        kw.setdefault("prefetch", False)
    cfg = api.ExecConfig(**{"rounds": rounds, "clients_per_round": K,
                            "seed": 5, "eval_every": 10 ** 9, **kw})
    out = dict(
        algo=api.AlgoConfig(name=algo, eta_l=0.05, eta_g=0.1),
        sampler=(samplers.MarkovSampler(NUM_CLIENTS, K, p_on=0.6, p_off=0.4)
                 if markov else None),
        runtime=None if rt is None else getattr(runtime, rt[0])(**rt[1]),
        fault_plan=None if plan is None else FaultPlan.seeded(7, **plan))
    out.update(over)
    return cfg, out


def port_trainer(name, exec_kw=None, **over):
    from repro_torch.core.api import FederatedTrainer
    cfg, kw = _args(name, "port", exec_kw, **over)
    return FederatedTrainer(port_loss, make_params(), NUM_CLIENTS,
                            ragged_batch_fn, cfg, device="cpu", **kw)


def port_resume(ckpt_dir, name, exec_kw=None, **over):
    from repro_torch.core.api import FederatedTrainer
    cfg, kw = _args(name, "port", exec_kw, **over)
    return FederatedTrainer.resume(ckpt_dir, port_loss, make_params(),
                                   NUM_CLIENTS, ragged_batch_fn, cfg,
                                   device="cpu", **kw)


def _ref_loss(p, batch):
    import jax.numpy as jnp
    pred = batch["x"] @ p["w"] + p["b"]
    return jnp.mean((pred - batch["y"]) ** 2)


def ref_trainer(name, exec_kw=None, **over):
    from repro.core.api import FederatedTrainer
    cfg, kw = _args(name, "ref", exec_kw, **over)
    return FederatedTrainer(_ref_loss, make_params(), NUM_CLIENTS,
                            ragged_batch_fn, cfg, **kw)


def ref_resume(ckpt_dir, name, exec_kw=None, **over):
    from repro.core.api import FederatedTrainer
    cfg, kw = _args(name, "ref", exec_kw, **over)
    return FederatedTrainer.resume(ckpt_dir, _ref_loss, make_params(),
                                   NUM_CLIENTS, ragged_batch_fn, cfg, **kw)


def run_cut(trainer, cut, ckpt_dir):
    """Run rounds [0, cut) and save."""
    with trainer:
        for t in range(cut):
            trainer.run_round(t)
        trainer.save(ckpt_dir)
    return trainer


def finals(tr) -> dict:
    """A port trainer's end state as numpy arrays: params, server state,
    server-optimizer moments, EF, schedule, losses, quarantine counts and
    the health window."""
    out = {"params": tr.flat.numpy().copy(),
           # the consumed schedule (the staging ring samples ahead)
           "schedule": np.stack(tr.state().schedule),
           "losses": np.asarray([r.train_loss for r in tr.history]),
           "quarantined": np.asarray([r.quarantined for r in tr.history])}
    for k, v in tr.server_state.items():
        out[f"state/{k}"] = v.numpy().copy()
    for k, v in (tr._opt_state or {}).items():
        out[f"opt/{k}"] = v.numpy().copy()
    if tr._ef is not None:
        out["ef"] = tr._ef.numpy().copy()
    if tr._health is not None:
        out["health_loss_window"] = np.asarray(
            tr._health.state_dict()["loss"], np.float64)
    if tr._guard is not None:
        out["guard_norms"] = np.asarray(tr._guard.state_dict()["norms"])
    return out


def main(phase, workdir, name):
    cut = CASES[name][6]
    ckpt_dir = os.path.join(workdir, "ckpt")
    if phase == "full":
        with port_trainer(name) as tr:
            tr.run()
    elif phase == "part":
        run_cut(port_trainer(name), cut, ckpt_dir)
    elif phase == "resume":
        with port_resume(ckpt_dir, name) as tr:
            assert tr.start_round == cut, tr.start_round
            tr.run()
    else:
        raise SystemExit(f"unknown phase {phase!r}")
    if phase in ("full", "resume"):
        np.savez(os.path.join(workdir, f"{phase}.npz"), **finals(tr))
    print(f"PHASE {phase} OK")


if __name__ == "__main__":
    main(*sys.argv[1:4])
