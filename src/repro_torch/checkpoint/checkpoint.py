"""Flat-npz pytree checkpointing with rotation — counterpart of
repro/checkpoint/checkpoint.py, writing the reference's on-disk format,
so a checkpoint either package writes restores in the other.

Paths are keyed ``step_<n>/state.npz``: the state tree's leaves as
arrays ``a0..aN`` in JAX's leaf order (sorted dict keys, lists in order),
and ``manifest.json`` records each leaf's key path spelled as JAX spells
it (``['params']/['conv1']/['w']``, ``[0]`` for a list index) with the
sha256 digests of the files written.

Two sidecar channels ride along with the state (both written atomically
into the same step dir, both rotated with it):

  * ``aux_arrays`` -> aux.npz — host-side numpy state round-tripped with
    exact dtypes (the trainer's MT19937 key vector comes back uint32,
    the cached gaussian float64, int8 codes int8);
  * ``aux_json``   -> aux.json — JSON-able metadata (round history,
    sampler state, config echoes).

Leaves may be numpy arrays or torch tensors on any device. A large state
(FedVARP's per-client table) is written one leaf at a time: each leaf is
copied to the host only when its turn comes, and an ``aux_arrays`` value
may be a zero-argument callable that makes its array then. The files are
what ``np.savez`` writes (an uncompressed zip of ``<name>.npy`` members).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import warnings
import zipfile
from typing import Any, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import bridge

PyTree = Any

# files covered by the manifest's content digests (aux sidecars are
# optional; only files actually written are digested)
_DIGESTED = ("state.npz", "aux.npz", "aux.json")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def to_host(x) -> np.ndarray:
    """A leaf -> a host numpy array with its exact dtype. A bf16 tensor
    becomes 2-byte void words, the bytes ``np.save`` writes for the
    reference's bf16 arrays."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(x)


def from_host(a: np.ndarray, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """A loaded array -> a CPU tensor (in ``dtype`` when given). 2-byte
    void words (a bf16 array as ``np.save`` stores it) come back as
    bf16, bit for bit."""
    a = a if a.flags.c_contiguous else np.ascontiguousarray(a)
    if _is_bf16_words(a):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = bridge._as_tensor(a)
    return t if dtype is None else t.to(dtype)


def _is_bf16_words(a: np.ndarray) -> bool:
    return a.dtype.kind == "V" and a.dtype.itemsize == 2


def _write_array(fh, arr: np.ndarray) -> None:
    """``np.lib.format.write_array``, except that 2-byte words (bf16) get
    the header descr ``'<V2'`` that numpy writes for the reference's
    ml_dtypes bf16 arrays."""
    if not _is_bf16_words(arr):
        np.lib.format.write_array(fh, arr, allow_pickle=False)
        return
    np.lib.format.write_array_header_1_0(fh, {
        "descr": "<V2", "fortran_order": False, "shape": arr.shape})
    fh.write(np.ascontiguousarray(arr).tobytes())


def _write_npz(path: str, items: Iterable[Tuple[str, Any]]) -> None:
    """``np.savez``'s layout — an uncompressed zip of ``<name>.npy``
    members, zip64 forced — written one member at a time: a value (or
    the array a callable value returns) reaches the host only when its
    member is written."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, val in items:
            arr = to_host(val() if callable(val) else val)
            with zf.open(name + ".npy", "w", force_zip64=True) as fh:
                _write_array(fh, arr)
            del arr


def _npz_headers(path: str) -> List[Tuple[Tuple[int, ...], np.dtype]]:
    """(shape, dtype) of members a0..aN of an npz, read from the .npy
    headers alone (no array data)."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            with zf.open(name) as fh:
                version = np.lib.format.read_magic(fh)
                read = (np.lib.format.read_array_header_1_0
                        if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
                shape, _, dtype = read(fh)
            out[name[:-4] if name.endswith(".npy") else name] = (shape,
                                                                 dtype)
    return [out[f"a{i}"] for i in range(len(out))]


def step_dir(ckpt_dir: str, step: int) -> str:
    """The directory of step ``step`` under ``ckpt_dir``: what ``save``
    returns, composed alike on every rank of a multi-process job, whose
    rank 0 alone writes it."""
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, state: PyTree, keep: int = 3,
         aux_arrays: Optional[dict] = None, aux_json: Any = None) -> str:
    """Atomic: everything lands in ``step_<n>.tmp`` first and is renamed
    into place only after the last byte is written, so a crash mid-save
    leaves the previous intact steps selectable by ``latest_step`` (the
    ``step_(\\d+)`` pattern never matches a torn .tmp dir)."""
    path = step_dir(ckpt_dir, step)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    pairs = list(bridge.tree_leaves_with_path(state))
    _write_npz(os.path.join(tmp, "state.npz"),
               ((f"a{i}", leaf) for i, (_, leaf) in enumerate(pairs)))
    if aux_arrays is not None:
        _write_npz(os.path.join(tmp, "aux.npz"), aux_arrays.items())
    if aux_json is not None:
        with open(os.path.join(tmp, "aux.json"), "w") as f:
            json.dump(aux_json, f, default=float)
    digests = {name: _sha256(os.path.join(tmp, name))
               for name in _DIGESTED
               if os.path.exists(os.path.join(tmp, name))}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step,
                   "keys": [bridge.jax_keystr(state, path)
                            for path, _ in pairs],
                   "digests": digests}, f)
    old = None
    if os.path.exists(path):        # re-saving the same step: keep the
        old = path + ".old"         # previous copy until the new one is
        shutil.rmtree(old, ignore_errors=True)   # fully in place
        os.rename(path, old)
    os.rename(tmp, path)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    _rotate(ckpt_dir, keep)
    return path


def load_aux(ckpt_dir: str, step: Optional[int] = None):
    """Load the (aux_arrays, aux_json) sidecars for ``step`` (latest if
    None). Missing sidecars come back as ({}, None)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    arrays = {}
    npz_path = os.path.join(path, "aux.npz")
    if os.path.exists(npz_path):
        with np.load(npz_path) as z:
            arrays = {k: z[k] for k in z.files}
    meta = None
    json_path = os.path.join(path, "aux.json")
    if os.path.exists(json_path):
        with open(json_path) as f:
            meta = json.load(f)
    return arrays, meta


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    # crash recovery for the re-save window in save(): if the process
    # died after the old copy was set aside but before the new one was
    # renamed in, step_N is absent and step_N.old holds the only intact
    # copy — restore it so the step stays selectable
    for d in os.listdir(ckpt_dir):
        if re.fullmatch(r"step_(\d+)\.old", d):
            bare = os.path.join(ckpt_dir, d[:-4])
            if not os.path.exists(bare):
                os.rename(os.path.join(ckpt_dir, d), bare)
    out = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "state.npz")):
            out.append(int(m.group(1)))
    return sorted(out)


def _rotate(ckpt_dir: str, keep: int):
    steps = _steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def verify_step(ckpt_dir: str, step: int) -> Optional[str]:
    """Content-integrity check for one step. Returns None when the step
    verifies, else a human-readable reason.

    A missing manifest is corruption (save() always writes one); a
    legacy manifest without ``digests`` is trusted as-is so pre-digest
    checkpoints keep restoring. Every digested file must still exist
    and hash to its recorded sha256 — truncation, bit-flips, and
    deleted sidecars all surface here instead of as silent bad math."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.isdir(path):
        return f"step dir {path} does not exist"
    man_path = os.path.join(path, "manifest.json")
    if not os.path.exists(man_path):
        return "manifest.json missing"
    try:
        with open(man_path) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        return f"manifest.json unreadable: {e}"
    digests = manifest.get("digests")
    if digests is None:      # legacy (pre-digest) checkpoint: trusted
        return None
    for name, want in digests.items():
        fpath = os.path.join(path, name)
        if not os.path.exists(fpath):
            return f"{name} missing (recorded in manifest)"
        got = _sha256(fpath)
        if got != want:
            return (f"{name} digest mismatch: manifest {want[:12]}..., "
                    f"file {got[:12]}... (truncated or corrupted)")
    return None


def resolve_step(ckpt_dir: str, step: Optional[int] = None) -> int:
    """Pick the step to restore, verifying content digests.

    Explicit ``step``: verified and returned, or ValueError with the
    corruption reason — an explicit request never silently falls back.
    ``step=None``: walk the available steps newest-first and return the
    first that verifies (self-healing last-good fallback), warning for
    each corrupt step skipped; FileNotFoundError when none survive."""
    if step is not None:
        reason = verify_step(ckpt_dir, step)
        if reason is not None:
            raise ValueError(
                f"checkpoint step {step} in {ckpt_dir} failed "
                f"verification: {reason}")
        return step
    steps = _steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    for s in reversed(steps):
        reason = verify_step(ckpt_dir, s)
        if reason is None:
            return s
        warnings.warn(
            f"skipping corrupt checkpoint step {s} in {ckpt_dir}: "
            f"{reason}", RuntimeWarning)
    raise FileNotFoundError(
        f"no checkpoint step in {ckpt_dir} passed verification "
        f"(tried {list(reversed(steps))})")


def _state_path(ckpt_dir: str, step: Optional[int]) -> str:
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return os.path.join(ckpt_dir, f"step_{step:08d}", "state.npz")


def _check_shapes(path: str, leaves: List[Any]) -> None:
    headers = _npz_headers(path)
    if len(leaves) != len(headers):
        raise ValueError(f"checkpoint has {len(headers)} leaves, "
                         f"expected {len(leaves)}")
    for ref, (shape, _) in zip(leaves, headers):
        if tuple(ref.shape) != tuple(shape):
            raise ValueError(f"shape mismatch {tuple(ref.shape)} vs "
                             f"{tuple(shape)}")


def restore(ckpt_dir: str, like: PyTree, step: Optional[int] = None
            ) -> PyTree:
    """Restore into the structure of ``like`` (shapes validated): a tree
    of new tensors, each in its ``like`` leaf's dtype and on its device
    (the CPU for a numpy leaf)."""
    path = _state_path(ckpt_dir, step)
    leaves = bridge.tree_leaves(like)
    _check_shapes(path, leaves)
    out = []
    with np.load(path) as z:
        for i, ref in enumerate(leaves):
            if isinstance(ref, torch.Tensor):
                dtype, device = ref.dtype, ref.device
            else:
                dtype = from_host(np.zeros(0, np.asarray(ref).dtype)).dtype
                device = "cpu"
            out.append(from_host(z[f"a{i}"], dtype).to(device))
    it = iter(out)
    return bridge.tree_map(lambda _: next(it), like)


def restore_into(ckpt_dir: str, dest: PyTree,
                 step: Optional[int] = None) -> None:
    """Copy the saved leaves into ``dest``'s tensors in place (views into
    a flat buffer are fine), one leaf at a time: the host holds one leaf
    at once and no second copy of the state is made on the device.
    Every leaf's shape is validated before the first copy."""
    path = _state_path(ckpt_dir, step)
    leaves = bridge.tree_leaves(dest)
    _check_shapes(path, leaves)
    with np.load(path) as z:
        for i, t in enumerate(leaves):
            t.copy_(from_host(z[f"a{i}"], t.dtype))
