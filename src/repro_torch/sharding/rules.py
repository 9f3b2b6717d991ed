"""Which rows of the cohort a rank holds; the client-axis part of
repro/sharding/rules.py.

The port runs one process per rank, and rank r of a ``world``-rank job
holds the r-th contiguous slice of the padded cohort (the reference lays
its process-spanning clients axis out in process order, which gives the
same slices). Hierarchical edges split the same padded rows into equal
contiguous groups, so a rank's rows fall into one or more EDGE PIECES:
the intersections of its slice with the edge groups. The round folds
each piece with one kernel launch (core/feddpc.py).

The per-leaf rules of the model axis (``param_specs``,
``cohort_param_specs``, ...) are not ported (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

from typing import List, Optional, Tuple


def padded_rows(k: int, world: int) -> int:
    """K padded up to a multiple of the client axis."""
    return -(-int(k) // int(world)) * int(world)


def local_row_range(rank: int, world: int, nrows: int) -> Tuple[int, int]:
    """[lo, hi) of the ``nrows`` cohort rows that ``rank`` of ``world``
    holds. ``nrows`` must be a multiple of ``world`` (the padded cohort);
    a single process holds (0, nrows)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if nrows % world:
        raise ValueError(f"{nrows} rows do not split over {world} ranks; "
                         "pad the cohort (padded_rows)")
    per = nrows // world
    return rank * per, (rank + 1) * per


def edge_pieces(lo: int, hi: int, nrows: int,
                edges: Optional[int] = None) -> List[Tuple[int, int]]:
    """The rows [lo, hi) cut at the boundaries of ``edges`` equal groups
    of ``nrows`` rows, as global [a, b) ranges in row order; without
    edges, [(lo, hi)]."""
    if not edges or edges <= 1:
        return [(lo, hi)]
    if nrows % edges:
        raise ValueError(f"edges={edges} must divide the padded cohort "
                         f"({nrows} rows)")
    per = nrows // edges
    out = []
    a = lo
    while a < hi:
        b = min(hi, (a // per + 1) * per)
        out.append((a, b))
        a = b
    return out
