"""repro_torch.checkpoint against repro.checkpoint: the reference's four
checkpoint cases, trees each package saves restored by the other bit for
bit, the same manifest keys and files, and the newest-intact fallback
for every corruption mode (the ckpt_corrupt fault's consumer)."""
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_resume_check as rc
from repro.checkpoint import checkpoint as ref_ckpt
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import faults
from _torch_threads import one_intra_op_thread  # noqa: F401


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((4, 3), generator=g)
    return {"params": {"w": w, "layers": [torch.ones(2), torch.zeros(5)]},
            "delta_prev": {"w": w * 0.1,
                           "layers": [torch.ones(2), torch.zeros(5)]},
            "round": torch.tensor(7, dtype=torch.int32)}


def _np_state(seed):
    """A numpy tree with f32, int32, int8 and uint32 leaves, nested dicts
    and a list — both packages save it."""
    r = np.random.RandomState(seed)
    return {"params": {"w": r.randn(4, 3).astype(np.float32),
                       "layers": [r.randn(2).astype(np.float32),
                                  np.arange(5, dtype=np.int8)]},
            "server_state": {"t": np.float32(3.0),
                             "keys": r.randint(0, 2 ** 31, 6
                                               ).astype(np.uint32)},
            "round": np.int32(7)}


# ---- the reference's test_checkpoint.py cases ----

def test_roundtrip(tmp_path):
    s = _state(0)
    ckpt.save(str(tmp_path), 7, s)
    like = jax.tree.map(torch.zeros_like, s)
    r = ckpt.restore(str(tmp_path), like)
    for a, b in zip(jax.tree.leaves(s), jax.tree.leaves(r)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_rotation_keeps_last_k(tmp_path):
    for step in range(5):
        ckpt.save(str(tmp_path), step, _state(step), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    kept = sorted(os.listdir(tmp_path))
    assert len([d for d in kept if d.startswith("step_")]) == 2


def test_restore_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 0, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(3),
                                     "v": torch.zeros(1)})


def test_restore_latest(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.ones(2)})
    ckpt.save(str(tmp_path), 9, {"w": torch.full((2,), 9.0)})
    out = ckpt.restore(str(tmp_path), {"w": torch.zeros(2)})
    assert torch.equal(out["w"], torch.full((2,), 9.0))


# ---- across packages ----

def _assert_tree_bitwise(got, want):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_restores_in_the_reference_bitwise(tmp_path):
    s = _np_state(1)
    ckpt.save(str(tmp_path), 3, jax.tree.map(torch.from_numpy,
                                             jax.tree.map(np.asarray, s)))
    out = ref_ckpt.restore(str(tmp_path), jax.tree.map(jnp.zeros_like, s))
    _assert_tree_bitwise(jax.tree.map(np.asarray, out), s)


def test_reference_checkpoint_restores_in_the_port_bitwise(tmp_path):
    s = _np_state(2)
    ref_ckpt.save(str(tmp_path), 3, s)
    like = jax.tree.map(lambda x: torch.zeros_like(torch.from_numpy(
        np.asarray(x))), s)
    _assert_tree_bitwise(ckpt.restore(str(tmp_path), like), s)
    # and straight into existing tensors (the trainer's path)
    ckpt.restore_into(str(tmp_path), like)
    _assert_tree_bitwise(like, s)


def test_manifest_and_files_match_the_references(tmp_path):
    """The same tree saved by both: the same manifest keys (JAX's key
    path spelling), the same npz members, headers and array bytes, the
    same aux sidecars."""
    s = _np_state(3)
    aux = {"rng_keys": np.arange(4, dtype=np.uint32),
           "cached": np.float64(0.5)}
    meta = {"format": 1, "history": [{"round": 0, "train_loss": 1.5}]}
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    ckpt.save(mine, 2, s, aux_arrays=aux, aux_json=meta)
    ref_ckpt.save(ref, 2, s, aux_arrays=aux, aux_json=meta)
    m_man, r_man = (json.load(open(os.path.join(d, "step_00000002",
                                                "manifest.json")))
                    for d in (mine, ref))
    assert m_man["keys"] == r_man["keys"]
    assert m_man["keys"][:3] == ["['params']/['layers']/[0]",
                                 "['params']/['layers']/[1]",
                                 "['params']/['w']"]
    assert set(m_man["digests"]) == set(r_man["digests"]) == {
        "state.npz", "aux.npz", "aux.json"}
    assert m_man["digests"]["aux.json"] == r_man["digests"]["aux.json"]
    for name in ("state.npz", "aux.npz"):
        zips = [zipfile.ZipFile(os.path.join(d, "step_00000002", name))
                for d in (mine, ref)]
        assert zips[0].namelist() == zips[1].namelist()
        for member in zips[0].namelist():
            assert zips[0].read(member) == zips[1].read(member), member
    assert ckpt.load_aux(mine)[1] == ref_ckpt.load_aux(ref)[1]


def test_bf16_leaves_are_stored_as_the_reference_stores_them(tmp_path):
    """A bf16 tensor lands as the reference's ml_dtypes bf16 array does
    (2-byte words, the same bytes) and restores as bf16, bit for bit."""
    x = torch.randn(7).to(torch.bfloat16)
    ckpt.save(str(tmp_path / "m"), 0, {"q": x})
    ref_ckpt.save(str(tmp_path / "r"), 0, {"q": np.asarray(
        x.view(torch.int16).numpy().view(ml_dtypes.bfloat16))})
    members = [zipfile.ZipFile(str(tmp_path / d / "step_00000000" /
                                   "state.npz")).read("a0.npy")
               for d in ("m", "r")]
    assert members[0] == members[1]
    out = ckpt.restore(str(tmp_path / "r"),
                       {"q": torch.zeros(7, dtype=torch.bfloat16)})
    assert torch.equal(out["q"].view(torch.int16), x.view(torch.int16))


# ---- the newest-intact fallback (ckpt_corrupt's consumer) ----

@pytest.mark.parametrize("mode", ["truncate", "bitflip", "drop_digest",
                                  "missing_sidecar"])
def test_corrupt_newest_step_falls_back_to_last_good(mode, tmp_path):
    """Every corruption shape — truncated npz, digest mismatch (bitflip),
    missing manifest, missing digested sidecar — skips the damaged newest
    step with a RuntimeWarning and restores the older intact one BITWISE;
    an explicitly requested corrupt step fails loudly."""
    d = str(tmp_path)
    snaps = {}
    with rc.port_trainer("feddpc_guarded") as tr:
        for t in range(4):
            tr.run_round(t)
            if t in (1, 3):
                tr.save(d, keep=5)
                snaps[t + 1] = tr.flat.clone()
    if mode == "missing_sidecar":
        os.remove(os.path.join(d, "step_00000004", "aux.npz"))
    else:
        faults.corrupt_checkpoint(d, 4, mode)
    with pytest.warns(RuntimeWarning, match="skipping corrupt"):
        assert ckpt.resolve_step(d) == 2
    with pytest.warns(RuntimeWarning):
        tr = rc.port_resume(d, "feddpc_guarded")
    assert tr.start_round == 2
    assert torch.equal(tr.flat, snaps[2])
    tr.run_round(2)                 # and the run continues from there
    with pytest.raises(ValueError, match="failed verification"):
        rc.port_resume(d, "feddpc_guarded", step=4)


def test_ckpt_corrupt_plan_trains_and_names_the_steps(tmp_path):
    """A plan with a ckpt_corrupt injector now builds a trainer (its
    consumer is the fallback above) and says which steps it damages,
    as the reference's plan does."""
    plan = faults.FaultPlan(seed=3, injectors=(faults.CkptCorrupt(
        rounds=(2,), mode="bitflip"),))
    tr = rc.port_trainer("feddpc", fault_plan=plan)
    assert tr.fault_plan is plan
    assert [plan.ckpt_corruption(s) for s in range(4)] == [
        None, None, "bitflip", None]
