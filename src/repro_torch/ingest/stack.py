"""Cohort-stack stage of the ingest pipeline — ``stack_batches``,
``stack_cohort`` and ``stack_cohort_into`` of repro/ingest/stack.py, on
numpy trees without JAX.

They build the padded (K, M, ...) cohort stack the cohort round
consumes, plus the (K, M) validity mask; ``stack_cohort_into`` writes it
into a staging-ring slot's preallocated host tensors (pinned for a copy
to the card), so the per-round allocations leave the ingest path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bridge import tree_leaves, tree_leaves_with_path, tree_map


def stack_batches(batch_list, max_batches: int, template=None):
    """Pad a list of same-shape batch trees to (max_batches, ...) + mask.

    ``template`` (one batch tree, shapes/dtypes only) makes an EMPTY
    list stackable: a zero-data client contributes an all-zero stack
    with an all-False mask (the local loop no-ops, delta == 0) while
    still counting as a sampled client for the server rules."""
    n = len(batch_list)
    if n > max_batches:
        raise ValueError(f"{n} batches exceed the bucket of {max_batches}")
    if n == 0:
        if template is None:
            raise ValueError("stack_batches of an empty batch list needs a "
                             "template batch for the leaf shapes")
        stacked = tree_map(
            lambda x: np.zeros((max_batches,) + np.shape(x),
                               np.asarray(x).dtype), template)
        return stacked, np.zeros(max_batches, bool)
    stacked = tree_map(lambda *xs: np.stack(xs), *batch_list)
    if n < max_batches:
        pad = max_batches - n
        stacked = tree_map(
            lambda x: np.concatenate(
                [x, np.repeat(x[-1:], pad, axis=0)], axis=0), stacked)
    mask = np.arange(max_batches) < n
    return stacked, mask


def stack_cohort(per_client_batches, max_batches: int, pad_to: int = None):
    """Stack K clients' batch lists into one (K, M, ...) tree + (K, M)
    mask. M = max_batches is the shape bucket; ragged clients pad with
    masked repeats. ``pad_to`` > K appends dummy clients (copies of the
    last real row with an all-False mask row)."""
    template = next((b[0] for b in per_client_batches if b), None)
    if template is None:
        raise ValueError("every client in the cohort has zero batches")
    pairs = [stack_batches(b, max_batches, template=template)
             for b in per_client_batches]
    batches = tree_map(lambda *xs: np.stack(xs), *[p[0] for p in pairs])
    masks = np.stack([p[1] for p in pairs])
    k = len(per_client_batches)
    if pad_to is not None and pad_to > k:
        pad = pad_to - k
        batches = tree_map(
            lambda x: np.concatenate(
                [x, np.repeat(x[-1:], pad, axis=0)], axis=0), batches)
        masks = np.concatenate(
            [masks, np.zeros((pad,) + masks.shape[1:], bool)], axis=0)
    return batches, masks


def _rebuild(tree, leaves):
    """``tree`` with its leaves replaced by ``leaves``, given in
    ``tree_leaves`` order (dict keys sorted)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)
    return build(tree)


def stack_cohort_into(per_client_batches, max_batches: int, slot: dict,
                      pad_to: int = None, pin: bool = False):
    """``stack_cohort`` into PREALLOCATED host tensors owned by ``slot``
    (one mutable dict per staging-ring buffer): its (K, M, ...) tensors
    and (K, M) mask are allocated on first use — in pinned memory with
    ``pin``, so the copy to the card can run asynchronously — and
    reused every round; they are reallocated only when the cohort's
    shape changes (the grow-once M bucket keeps that rare). Their numpy
    views are filled in place. Returns (batches tree, mask) as CPU
    tensors backed by the slot; they stay valid until the slot is
    refilled.

    ``pad_to`` appends dummy clients exactly as ``stack_cohort`` does
    (copies of the last real row, all-False mask rows)."""
    k, m = len(per_client_batches), max_batches
    kp = k if pad_to is None else max(pad_to, k)
    first = next((b for b in per_client_batches if b), None)
    if first is None:
        raise ValueError("every client in the cohort has zero batches")
    paths, leaves0 = zip(*[(path, np.asarray(x)) for path, x in
                           tree_leaves_with_path(first[0])])
    key = (kp, m, pin, paths, tuple((x.shape, x.dtype.str) for x in leaves0))
    if slot.get("key") != key:
        slot["key"] = key
        slot["tensors"] = [
            torch.empty((kp, m) + x.shape,
                        dtype=torch.from_numpy(x[None][:0]).dtype,
                        pin_memory=pin) for x in leaves0]
        slot["mask_t"] = torch.empty((kp, m), dtype=torch.bool,
                                     pin_memory=pin)
        slot["bufs"] = [t.numpy() for t in slot["tensors"]]
        slot["mask"] = slot["mask_t"].numpy()
        slot["tree"] = first[0]
    bufs, mask = slot["bufs"], slot["mask"]
    for j, blist in enumerate(per_client_batches):
        n = len(blist)
        if n > m:
            raise ValueError(f"client row {j}: {n} batches exceed the "
                             f"bucket of {m}")
        if n == 0:                      # zero-data client: all-zero rows,
            for buf in bufs:            # fully masked — still a sampled
                buf[j] = 0              # client
            mask[j] = False
            continue
        for i, b in enumerate(blist):
            for buf, x in zip(bufs, tree_leaves(b)):
                buf[j, i] = x
        if n < m:                       # ragged: pad with masked repeats
            for buf in bufs:
                buf[j, n:] = buf[j, n - 1]
        mask[j] = np.arange(m) < n
    for j in range(k, kp):              # dummy clients: masked copies
        for buf in bufs:
            buf[j] = buf[k - 1]
        mask[j] = False
    return _rebuild(slot["tree"], slot["tensors"]), slot["mask_t"]
