"""Tile-sparse dense hub block: planning and building (numpy; the mask
fill in the native library where it is available, dgnn_tpu_torch/native).

Copy of ``dgnn_tpu/graph/hub.py`` without the half-row schedule (a TPU
memory workaround that the CUDA kernels do not need).  Under
``dense="auto"`` the planner picks the [DENSE_RT x DENSE_CT] tiles of the
degree-ranked adjacency plane worth routing through the dense hub-block
kernels (ops/dense.py); ``build_dense_numpy`` splits a direction into that
block and the residual CSR that the degree bins take.  The constants mirror
``dgnn_tpu/graph/hub.py`` so that both packages plan the same layout for the
same graph; they are the JAX package's cost model, rates of a TPU, and not a
measurement of this port.

Mask format ("bit-plane" packing): within a tile, the adjacency bit of
column j lives in byte j % (CT/8), bit j // (CT/8).  This is not
``np.packbits`` order; ``pack_mask_bits`` permutes the columns first.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native

__all__ = ["DensePlan", "plan_dense", "build_dense_numpy", "pack_mask_bits",
           "DENSE_RT", "DENSE_CT"]

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


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """Host-side tile-sparse dense block.

    ``row_ids``/``col_ids`` are the kept row chunks'/column tiles' node ids
    concatenated in degree-rank order (0-padded to DENSE_RT/DENSE_CT
    multiples); ``mask[t]`` is the bit-plane packed adjacency of schedule
    entry t, whose rows are ``row_ids[rc[t]*RT:(rc[t]+1)*RT]`` and columns
    ``col_ids[ct[t]*CT:(ct[t]+1)*CT]``.  The schedule is sorted by (rc, ct),
    so each row chunk's entries are consecutive; ``first[t]`` marks the
    first entry of its row chunk."""

    row_ids: np.ndarray   # [Rpad] int32 (kept chunks, rank order, 0-padded)
    col_ids: np.ndarray   # [Cpad] int32 (kept col tiles, rank order)
    mask: np.ndarray      # [T, DENSE_RT, DENSE_CT//8] uint8 bit-plane packed
    rc: np.ndarray        # [T] int32 row-chunk index per schedule entry
    ct: np.ndarray        # [T] int32 col-tile index per schedule entry
    first: np.ndarray     # [T] int32 1 iff first entry of its row chunk
    num_rows: int         # real (unpadded) row count


def pack_mask_bits(mask01: np.ndarray, ct: int = DENSE_CT) -> np.ndarray:
    """[R, C] bool (C % ct == 0) -> [R, C//8] uint8 bit-plane packed.

    Within each ct-column tile, the bit of column j lives in byte
    j % (ct//8), bit j // (ct//8): the layout ops/dense.unpack_mask
    inverts."""
    R, C = mask01.shape
    if C % ct:
        raise ValueError(f"mask width {C} is not a multiple of {ct}")
    cb = ct // 8
    j = np.arange(ct)
    # packed position p = 8q+k (np.packbits little: byte q bit k <- col 8q+k)
    # must hold logical slot k*cb + q, so col p of the packbits input is
    # logical slot (p % 8) * cb + p // 8
    perm = (j % 8) * cb + j // 8
    tiles = mask01.reshape(R, C // ct, ct)[:, :, perm]
    return np.packbits(tiles.reshape(R, C), axis=1, bitorder="little")


def _mask_fill_numpy(rows: np.ndarray, cols: np.ndarray, rpad: int,
                     cpad: int, ct: int) -> np.ndarray:
    """native.dense_mask_fill's numpy version: an [rpad, cpad] bool image
    with (rows[i], cols[i]) set, bit-plane packed to [rpad, cpad // 8]."""
    mask01 = np.zeros((rpad, cpad), bool)
    mask01[rows, cols] = True
    return pack_mask_bits(mask01, ct)


def _pad_to(x: np.ndarray, m: int) -> np.ndarray:
    pad = (-len(x)) % m
    return np.concatenate([x, np.zeros(pad, x.dtype)]) if pad else x


def build_dense_numpy(row_ptr: np.ndarray, col_ind: np.ndarray,
                      row_sel: np.ndarray, col_sel: np.ndarray,
                      keep: np.ndarray | None = None,
                      num_cols: int | None = None):
    """Materialize the tile-sparse dense block and the residual CSR.

    Args:
      row_ptr/col_ind: the adjacency (either direction; ``num_cols`` when
        the column id space differs from the row count).
      row_sel: node ids whose rank rows take part (rank order = position);
        col_sel: node ids whose rank columns take part.  ``keep[i, j]``
        selects tile (row chunk i of row_sel, col tile j of col_sel); None
        keeps every tile (a forced block).  An edge is dense iff its
        (row, col) lands in a kept tile; every other edge is residual.
    Returns (DensePlan, residual_row_ptr, residual_col_ind,
             residual_edge_ids), the last being positions into the original
      col_ind.
    """
    row_ptr = np.asarray(row_ptr, np.int64)
    col_ind = np.asarray(col_ind, np.int64)
    n = len(row_ptr) - 1
    nc = n if num_cols is None else int(num_cols)
    deg = np.diff(row_ptr)
    row_sel = np.asarray(row_sel, np.int64)
    col_sel = np.asarray(col_sel, np.int64)

    nrc = -(-len(row_sel) // DENSE_RT)
    nct = -(-len(col_sel) // DENSE_CT)
    if keep is None:
        keep = np.ones((nrc, nct), bool)
    keep = np.asarray(keep, bool)
    if keep.shape != (nrc, nct):
        raise ValueError(f"keep has shape {keep.shape}, expected "
                         f"{(nrc, nct)}")

    # rank position (or -1) per node id, in each axis
    row_rank = np.full(n, -1, np.int64)
    row_rank[row_sel] = np.arange(len(row_sel))
    col_rank = np.full(nc, -1, np.int64)
    col_rank[col_sel] = np.arange(len(col_sel))

    # compact kept chunks / col tiles
    kept_rc = np.nonzero(keep.any(axis=1))[0]       # original chunk index
    kept_ct = np.nonzero(keep.any(axis=0))[0]
    rc_pos = np.full(nrc, -1, np.int64)
    rc_pos[kept_rc] = np.arange(len(kept_rc))
    ct_pos = np.full(nct, -1, np.int64)
    ct_pos[kept_ct] = np.arange(len(kept_ct))
    # schedule: kept tiles sorted by (compacted rc, compacted ct)
    t_i, t_j = np.nonzero(keep)
    order = np.lexsort((ct_pos[t_j], rc_pos[t_i]))
    t_i, t_j = t_i[order], t_j[order]
    rc_arr = rc_pos[t_i].astype(np.int32)
    ct_arr = ct_pos[t_j].astype(np.int32)
    first = np.ones(len(rc_arr), np.int32)
    first[1:] = (rc_arr[1:] != rc_arr[:-1]).astype(np.int32)
    tile_id = np.full((nrc, nct), -1, np.int64)
    tile_id[t_i, t_j] = np.arange(len(t_i))
    T = len(t_i)

    # per-edge tile membership
    rows_per_edge = np.repeat(np.arange(n), deg)
    er_rank = row_rank[rows_per_edge]
    ec_rank = col_rank[col_ind]
    inside = (er_rank >= 0) & (ec_rank >= 0)
    et = np.full(len(col_ind), -1, np.int64)
    et[inside] = tile_id[er_rank[inside] // DENSE_RT,
                         ec_rank[inside] // DENSE_CT]
    e_dense = et >= 0

    # residual CSR (row ids unchanged)
    keep_e = ~e_dense
    res_counts = np.bincount(rows_per_edge[keep_e], minlength=n)
    res_row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(res_counts, out=res_row_ptr[1:])
    res_col_ind = col_ind[keep_e]
    res_edge_ids = np.nonzero(keep_e)[0]

    # per-tile masks as one bit-plane packed [T*RT, CT//8] image: one O(E)
    # pass in the native library where it is available
    er = et[e_dense] * DENSE_RT + er_rank[e_dense] % DENSE_RT
    ec = ec_rank[e_dense] % DENSE_CT
    fill = native.dense_mask_fill if native.available() else \
        _mask_fill_numpy
    mask = fill(er, ec, T * DENSE_RT, DENSE_CT, DENSE_CT).reshape(
        T, DENSE_RT, DENSE_CT // 8)

    # compacted id lists (kept chunks'/tiles' ranks, 0-padded)
    row_chunks = _pad_to(row_sel, DENSE_RT).reshape(-1, DENSE_RT)
    col_tiles = _pad_to(col_sel, DENSE_CT).reshape(-1, DENSE_CT)
    row_ids = row_chunks[kept_rc].reshape(-1)
    col_ids = col_tiles[kept_ct].reshape(-1)
    # real (unpadded) rows among the kept chunks: all but the possibly
    # part-padded last chunk of row_sel
    real = np.zeros(nrc * DENSE_RT, bool)
    real[:len(row_sel)] = True
    num_real = int(real.reshape(nrc, DENSE_RT)[kept_rc].sum())

    plan = DensePlan(
        row_ids=row_ids.astype(np.int32),
        col_ids=col_ids.astype(np.int32),
        mask=mask,
        rc=rc_arr,
        ct=ct_arr,
        first=first,
        num_rows=num_real,
    )
    return plan, res_row_ptr, res_col_ind, res_edge_ids
