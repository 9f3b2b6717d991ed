"""Cohort-stack stage of the ingest pipeline — ``stack_batches`` and
``stack_cohort`` of repro/ingest/stack.py, on numpy trees without JAX.

They build the padded (K, M, ...) cohort stack the cohort round
consumes, plus the (K, M) validity mask.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bridge import tree_map


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
