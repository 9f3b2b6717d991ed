"""[Copy of repro/data/dirichlet.py — numpy only, verbatim apart from imports.]

Heterogeneous client partitioning via Dirichlet allocation
(Yurochkin et al. scheme, as used by FedDPC §5.1).

For each class r, sample P_r ~ Dir_k(alpha) and give client j a
P_{r,j} fraction of class r's samples. Small alpha -> highly skewed
label distributions per client.
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, num_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2) -> List[np.ndarray]:
    """-> list of index arrays, one per client (disjoint, covering all)."""
    rng = np.random.RandomState(seed)
    classes = np.unique(labels)
    for _ in range(100):
        client_idx = [[] for _ in range(num_clients)]
        for r in classes:
            idx_r = np.where(labels == r)[0]
            rng.shuffle(idx_r)
            p = rng.dirichlet(np.full(num_clients, alpha))
            cuts = (np.cumsum(p) * len(idx_r)).astype(int)[:-1]
            for j, part in enumerate(np.split(idx_r, cuts)):
                client_idx[j].extend(part.tolist())
        sizes = [len(c) for c in client_idx]
        if min(sizes) >= min_size:
            break
    else:
        # retries exhausted: force-feed starved clients from the largest
        # ones so every client can form at least one batch
        for j in range(num_clients):
            while len(client_idx[j]) < min_size:
                donor = max(range(num_clients),
                            key=lambda i: len(client_idx[i]))
                if donor == j or len(client_idx[donor]) <= min_size:
                    break
                client_idx[j].append(client_idx[donor].pop())
    return [np.asarray(sorted(c), dtype=np.int64) for c in client_idx]


def partition_stats(labels: np.ndarray, parts: List[np.ndarray]) -> dict:
    classes = np.unique(labels)
    mat = np.zeros((len(parts), len(classes)))
    for j, idx in enumerate(parts):
        for ci, c in enumerate(classes):
            mat[j, ci] = np.sum(labels[idx] == c)
    row = mat / np.maximum(mat.sum(1, keepdims=True), 1)
    uni = np.full(len(classes), 1.0 / len(classes))
    tv = 0.5 * np.abs(row - uni).sum(1)           # total-variation from uniform
    return {"sizes": mat.sum(1).astype(int).tolist(),
            "mean_tv_from_uniform": float(tv.mean()),
            "max_tv_from_uniform": float(tv.max())}
