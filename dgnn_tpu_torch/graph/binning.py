"""Degree-aware row binning (numpy), a copy of ``dgnn_tpu/graph/binning.py``.

Rows are grouped into bins by degree; each bin is a dense, padded
``[segments, width]`` table of neighbour ids, and rows longer than the
widest bin split into several segments whose partial (max, sum, acc)
results are merged by a log-sum-exp combine (ops/common.py).  The widths,
the slot tables and the combine tables are identical to the JAX package's
for the same graph (tests/test_torch_graph.py), so both packages feed their
kernels the same layout.

All construction runs once per graph on the host, in vectorized numpy;
the slot tables are filled by the native library where it is available
(dgnn_tpu_torch/native), by ``_bin_fill_numpy`` where not.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .. import native

__all__ = ["BinnedCSR", "bin_csr", "auto_widths", "combine_table",
           "combine_tables", "DEFAULT_WIDTHS"]

DEFAULT_WIDTHS = (8, 32, 128, 512)

# ~1.4x geometric grid: powers of two and 3*2^k, up to 128K
_WIDTH_CANDIDATES = tuple(sorted(
    [2 ** k for k in range(2, 18)] + [3 * 2 ** k for k in range(2, 16)]))

# Fixed cost of an extra bin, in padded slots.  Mirrors
# dgnn_tpu/graph/binning.py so that both packages pick the same widths.
_BIN_PENALTY_SLOTS = 12288


def auto_widths(deg, max_bins: int = 8, candidates=_WIDTH_CANDIDATES,
                bin_penalty: int = _BIN_PENALTY_SLOTS,
                max_segs_per_row: int = 8) -> tuple:
    """Pick bin widths minimizing total padded slots for this degree
    distribution.  Cost model per bin: each slot is one gathered row, each
    segment one resident-row fetch, plus ``bin_penalty`` slots per extra bin,
    plus the merge cost of the top width (every unit of the combine width
    Km costs N rows per pass).

    Constraint: the largest width must satisfy ceil(dmax/wmax) <=
    ``max_segs_per_row`` (it bounds the combine-table width)."""
    deg = np.asarray(deg)
    n_all = int(deg.size)  # the combine table covers every row
    deg = deg[deg > 0]
    if deg.size == 0:
        return (candidates[0],)
    dmax = int(deg.max())
    cands = [int(w) for w in sorted(set(candidates))]
    cover = [w for w in cands if w >= dmax]
    if cover:  # drop widths beyond the smallest one covering dmax
        cands = [w for w in cands if w <= cover[0]]
    wmax_min = -(-dmax // max_segs_per_row)  # smallest admissible top width
    if not any(w >= wmax_min for w in cands):
        cands.append(int(2 ** np.ceil(np.log2(wmax_min))))
    nc = len(cands)

    n_le = np.array([np.count_nonzero(deg <= w) for w in cands], np.int64)
    sorted_deg = np.sort(deg)

    def top_cost(lo_i, j):
        w = cands[j]
        lo = cands[lo_i] if lo_i >= 0 else 0
        rows = sorted_deg[np.searchsorted(sorted_deg, lo, side="right"):]
        if rows.size == 0:
            return 0
        nseg = int(np.sum(-(-rows // w)))
        return nseg * (w + 1)

    # merge cost of top width j: N * Km, Km = the capped combine width
    max_ov = max(64, n_all // 1000)
    merge_cost = np.empty(nc, np.int64)
    for j in range(nc):
        km = -(-dmax // cands[j])
        for c in range(1, km):
            over = deg.size - np.searchsorted(sorted_deg, c * cands[j],
                                              side="right")
            if over <= max_ov:
                km = c
                break
        merge_cost[j] = n_all * km

    # interval DP over increasing inner widths
    inner = np.empty((nc + 1, nc), np.int64)
    for j in range(nc):
        for i in range(-1, j):
            cnt = n_le[j] - (n_le[i] if i >= 0 else 0)
            inner[i + 1][j] = cnt * (cands[j] + 1)

    INF = 1 << 62
    max_r = min(max_bins - 1, nc)
    dp = np.full((nc, max_r + 1), INF, np.int64)
    par = np.full((nc, max_r + 1), -2, np.int64)
    for j in range(nc):
        dp[j][1] = inner[0][j]
        par[j][1] = -1
    for r in range(2, max_r + 1):
        for j in range(nc):
            for i in range(j):
                if dp[i][r - 1] < INF:
                    c = dp[i][r - 1] + inner[i + 1][j]
                    if c < dp[j][r]:
                        dp[j][r] = c
                        par[j][r] = i

    best, best_cost = None, None
    for j in range(nc):  # top (split) bin
        if -(-dmax // cands[j]) > max_segs_per_row:
            continue
        c = top_cost(-1, j) + merge_cost[j]
        if best_cost is None or c < best_cost:
            best, best_cost = [j], c
        for i in range(j):  # inner bins end at cands[i]
            for r in range(1, max_r + 1):
                if dp[i][r] >= INF:
                    continue
                c = (dp[i][r] + top_cost(i, j) + r * bin_penalty
                     + merge_cost[j])
                if c < best_cost:
                    chain, jj, rr = [], i, r
                    while jj >= 0:
                        chain.append(jj)
                        jj = int(par[jj][rr])
                        rr -= 1
                    best = list(reversed(chain)) + [j]
                    best_cost = c
    return tuple(cands[j] for j in best)


def combine_table(rows_concat: np.ndarray, num_rows: int,
                  valid: np.ndarray | None = None) -> np.ndarray:
    """[R, K] int32 positions of each row's segment partials in the
    concatenated per-bin order (-1 padded); K = max segments per row.
    ``valid`` masks out padding segments (count == 0)."""
    rows_concat = np.asarray(rows_concat, dtype=np.int64)
    pos = np.arange(rows_concat.shape[0], dtype=np.int64)
    if valid is not None:
        keep = np.asarray(valid).astype(bool)
        rows_concat = rows_concat[keep]
        pos = pos[keep]
    counts = np.bincount(rows_concat, minlength=num_rows)
    k = max(int(counts.max(initial=0)), 1)
    tbl = np.full((num_rows, k), -1, np.int32)
    order = np.argsort(rows_concat, kind="stable")
    sorted_rows = rows_concat[order]
    first = np.zeros(num_rows + 1, np.int64)
    np.cumsum(counts, out=first[1:])
    slot = np.arange(len(order), dtype=np.int64) - first[sorted_rows]
    tbl[sorted_rows, slot] = pos[order].astype(np.int32)
    return tbl


def combine_tables(rows_concat: np.ndarray, num_rows: int,
                   valid: np.ndarray | None = None):
    """Capped-width combine table + tiny overflow table.

    Returns ``(main [R, Km], ov_rows [V], ov [V, K])``: ``main`` holds rows
    with <= Km partials (Km = smallest width covering all but <=0.1% of
    rows, at least 64 allowed over); the V overflow rows have -1s in
    ``main`` and their full lists in ``ov``."""
    tbl = combine_table(rows_concat, num_rows, valid)
    k = tbl.shape[1]
    counts = (tbl >= 0).sum(axis=1)
    max_ov = max(64, num_rows // 1000)
    km = k
    for cand in range(1, k):
        if int((counts > cand).sum()) <= max_ov:
            km = cand
            break
    ov_rows = np.nonzero(counts > km)[0].astype(np.int32)
    ov = tbl[ov_rows]
    main = tbl[:, :km].copy()
    main[ov_rows] = -1
    return main, ov_rows, ov


# Segments per bin are padded to a multiple of this (same as the JAX
# package, so the two layouts stay identical).
_SEG_PAD = 8


@dataclasses.dataclass(frozen=True)
class BinnedCSR:
    """One direction of a binned adjacency (numpy, host-side).

    Per bin ``b`` (all padded with zeros where ``slot >= count``):
      nbr[b]   : [S_b, W_b] int32 — neighbor node id per slot
      edge[b]  : [S_b, W_b] int32 — global CSR edge id per slot
      row[b]   : [S_b] int32 — original row id of the segment
      count[b] : [S_b] int32 — number of valid slots in the segment
    """

    nbr: tuple
    edge: tuple
    row: tuple
    count: tuple
    widths: tuple
    num_rows: int
    num_edges: int

    @property
    def num_bins(self) -> int:
        return len(self.widths)


def _build_bin(col_ind, edge_ids, rows, starts, counts, width):
    """Materialize the dense [S, width] slot table for the given segments
    (in the native library where it is available, else numpy)."""
    pad = (-rows.shape[0]) % _SEG_PAD
    if pad:
        rows = np.concatenate([rows, np.zeros(pad, np.int64)])
        starts = np.concatenate([starts, np.zeros(pad, np.int64)])
        counts = np.concatenate([counts, np.zeros(pad, np.int64)])
    if native.available():
        nbr, edge = native.bin_fill(starts, counts, width, col_ind, edge_ids)
    else:
        nbr, edge = _bin_fill_numpy(starts, counts, width, col_ind, edge_ids)
    return nbr, edge, rows.astype(np.int32), counts.astype(np.int32)


def _bin_fill_numpy(starts, counts, width, col_ind, edge_ids):
    """native.bin_fill's numpy version: ([S, width] nbr, [S, width] edge)
    int32, segment s holding CSR slots [starts[s], starts[s] + counts[s])
    and zeros after them."""
    lane = np.arange(width, dtype=np.int64)[None, :]
    mask = lane < counts[:, None]
    offs = np.where(mask, starts[:, None] + lane, 0)
    nbr = np.where(mask, col_ind[offs], 0).astype(np.int32)
    edge = np.where(mask, edge_ids[offs], 0).astype(np.int32)
    return nbr, edge


def bin_csr(
    row_ptr: np.ndarray,
    col_ind: np.ndarray,
    edge_ids: np.ndarray | None = None,
    widths: Sequence[int] = DEFAULT_WIDTHS,
    keep_empty: bool = False,
) -> BinnedCSR:
    """Bin a CSR adjacency by row degree into padded fixed-width tables.

    ``edge_ids[j]`` gives the global edge id of CSR slot ``j`` (identity for
    the forward graph; the `permute` array for the transposed graph).
    Bins that no row falls into are left out, unless ``keep_empty``: then
    each is kept as _SEG_PAD empty segments, so graphs binned with the same
    widths have the same bins (the graph shards of parallel/partition.py).
    """
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    num_rows = row_ptr.shape[0] - 1
    # the slot tables are int32: convert once, not once a bin
    col_ind = np.ascontiguousarray(col_ind, dtype=np.int32)
    num_edges = col_ind.shape[0]
    if edge_ids is None:
        edge_ids = np.arange(num_edges, dtype=np.int64)
    else:
        edge_ids = np.ascontiguousarray(edge_ids, dtype=np.int64)
    deg = np.diff(row_ptr)

    widths = tuple(sorted(set(int(w) for w in widths)))
    if not widths:
        raise ValueError("need at least one bin width")

    nbr_b, edge_b, row_b, count_b, used_widths = [], [], [], [], []
    lo = 0
    wmax = widths[-1]
    for w in widths:
        if w == wmax:
            sel = np.nonzero(deg > lo)[0]  # includes mega-rows, split below
        else:
            sel = np.nonzero((deg > lo) & (deg <= w))[0]
        lo = w
        if sel.size == 0:
            if keep_empty:
                nbr_b.append(np.zeros((_SEG_PAD, w), np.int32))
                edge_b.append(np.zeros((_SEG_PAD, w), np.int32))
                row_b.append(np.zeros(_SEG_PAD, np.int32))
                count_b.append(np.zeros(_SEG_PAD, np.int32))
                used_widths.append(w)
            continue
        d = deg[sel]
        if w == wmax:
            nseg = -(-d // w)  # ceil
            rows = np.repeat(sel, nseg)
            first = np.cumsum(nseg) - nseg
            seg_i = (np.arange(rows.shape[0], dtype=np.int64)
                     - np.repeat(first, nseg))
            starts = row_ptr[rows] + seg_i * w
            counts = np.minimum(w, deg[rows] - seg_i * w)
        else:
            rows, starts, counts = sel, row_ptr[sel], d
        n, e, r, c = _build_bin(col_ind, edge_ids, rows, starts, counts, w)
        nbr_b.append(n)
        edge_b.append(e)
        row_b.append(r)
        count_b.append(c)
        used_widths.append(w)

    if not used_widths:  # empty graph: emit one empty bin for shape stability
        w = widths[0]
        nbr_b = [np.zeros((_SEG_PAD, w), np.int32)]
        edge_b = [np.zeros((_SEG_PAD, w), np.int32)]
        row_b = [np.zeros(_SEG_PAD, np.int32)]
        count_b = [np.zeros(_SEG_PAD, np.int32)]
        used_widths = [w]

    return BinnedCSR(
        nbr=tuple(nbr_b),
        edge=tuple(edge_b),
        row=tuple(row_b),
        count=tuple(count_b),
        widths=tuple(used_widths),
        num_rows=num_rows,
        num_edges=num_edges,
    )
