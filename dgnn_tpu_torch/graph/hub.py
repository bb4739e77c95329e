"""Hub-block planning (numpy): does a graph keep a dense hub block?

Copy of ``plan_dense`` and its constants from ``dgnn_tpu/graph/hub.py``.
Under ``dense="auto"`` the planner picks the tiles of the degree-ranked
adjacency plane worth routing through the dense hub-block kernels.  The
constants mirror ``dgnn_tpu/graph/hub.py`` so that both packages plan the
same layout for the same graph; they are the JAX package's cost model and
are not a measurement of this port.

Building the block (``build_dense_numpy``, ``pack_mask_bits``) and its
kernels (``dense_gat_fwd`` / ``dense_gat_bwd``) are not ported yet:
graph/structure.py refuses a graph whose plan keeps a block.
"""

from __future__ import annotations

import numpy as np

__all__ = ["plan_dense", "DENSE_RT", "DENSE_CT"]

# Tile shape of the hub block: row chunk x column tile.
DENSE_RT = 256
DENSE_CT = 2048

# Planner constants, equal to dgnn_tpu/graph/hub.py.
DENSE_PAIRS_PER_S = 6.5e10
GATHER_ROWS_PER_S = 45e6
SPARSE_PAD = 1.25
MIN_SAVE_S = 50e-6


def plan_dense(row_ptr: np.ndarray, col_ind: np.ndarray,
               out_deg: np.ndarray, *,
               mask_budget_bytes: int = 1 << 30,
               heads: int = 4):
    """Select the degree-ranked tiles worth routing through the hub block.

    Returns (rows_by_rank, cols_by_rank, keep[nrc, nct] bool) or None when
    no tile beats the gather path.  ``keep[i, j]`` covers rank rows
    [i*RT, (i+1)*RT) x rank cols [j*CT, (j+1)*CT).  The column index space
    is ``len(out_deg)``.
    """
    row_ptr = np.asarray(row_ptr, np.int64)
    deg_in = np.diff(row_ptr)
    n = len(deg_in)
    n_cols = len(out_deg)
    rows_by_rank = np.argsort(deg_in, kind="stable")[::-1].astype(np.int64)
    cols_by_rank = np.argsort(out_deg, kind="stable")[::-1].astype(np.int64)
    rank_in = np.empty(n, np.int64)
    rank_in[rows_by_rank] = np.arange(n)
    rank_out = np.empty(n_cols, np.int64)
    rank_out[cols_by_rank] = np.arange(n_cols)

    nrc = -(-n // DENSE_RT)
    nct = -(-n_cols // DENSE_CT)
    ti = (np.repeat(rank_in, deg_in) // DENSE_RT).astype(np.int64)
    tj = (rank_out[col_ind] // DENSE_CT).astype(np.int64)
    hist = np.bincount(ti * nct + tj, minlength=nrc * nct).reshape(nrc, nct)

    eg = SPARSE_PAD / GATHER_ROWS_PER_S              # s saved per edge
    tile_s = DENSE_RT * DENSE_CT / DENSE_PAIRS_PER_S  # s per kept tile
    save = hist * eg - tile_s                        # [nrc, nct] float
    keep = save > 0
    # amortize setup gathers: drop whole col tiles / row chunks whose summed
    # tile savings don't cover their per-pass setup gather
    col_setup = DENSE_CT / GATHER_ROWS_PER_S
    row_setup = DENSE_RT / GATHER_ROWS_PER_S
    for _ in range(3):
        col_sav = np.where(keep, save, 0.0).sum(axis=0) - col_setup
        keep &= (col_sav > 0)[None, :]
        row_sav = np.where(keep, save, 0.0).sum(axis=1) - row_setup
        keep &= (row_sav > 0)[:, None]
    if not keep.any():
        return None
    total = (np.where(keep, save, 0.0).sum()
             - col_setup * keep.any(axis=0).sum()
             - row_setup * keep.any(axis=1).sum())
    if total < MIN_SAVE_S:
        return None
    # mask budget: keep the highest-saving tiles
    t_bytes = DENSE_RT * DENSE_CT // 8
    max_tiles = max(1, mask_budget_bytes // t_bytes)
    if keep.sum() > max_tiles:
        flat = np.where(keep, save, -np.inf).ravel()
        cutoff = np.partition(flat, -max_tiles)[-max_tiles]
        keep &= (save >= cutoff)
    return rows_by_rank, cols_by_rank, keep
