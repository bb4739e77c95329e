"""Graph containers as dataclasses of torch tensors.

Port of ``dgnn_tpu/graph/structure.py``: raw CSR/CSC for generic use plus
the two degree-binned layouts (binning.py) that the fused ops consume,
each with its optional tile-sparse dense hub block (hub.py).  Every
container has ``.to(device)``; the host build returns CPU tensors.

The work list of the hub-block MoNet kernels (``WorkList``;
csrc/dense_gmm.cu) is a pure function of a block's arrays (``work_list``,
``split_budget``): where one of its rows holds more edges than the budget,
the rows are cut at tile boundaries into pieces that the kernels walk a
warp a piece, so that one long row no longer sets the length of a launch.
ops/dense.py makes a block's list at its first MoNet launch; it is never
stored in the cache.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from ..utils.profiling import span
from . import binning as _binning
from . import build as _build
from . import hub as _hub

__all__ = ["BinnedAdj", "CombineTable", "DenseBlock", "Graph", "WorkList",
           "build_graph", "build_graph_from_csr", "from_binned",
           "split_budget", "work_list", "PIECES_PER_WARP",
           "ROW_FLOOR"]

# The work list's budget (``split_budget``): a row is cut into pieces of at
# most the block's edges over PIECES_PER_WARP times the warps the kernels
# keep resident on the card, and never below ROW_FLOOR edges (one tile
# row's most), so a row of one tile is never cut and blocks of short rows
# (cora's, 4.4 edges a row) keep a piece a row.  PIECES_PER_WARP was
# measured on the Reddit stand-in's blocks (H100; PERF.md §6): K7 and
# K8 ms a launch at 1, 2, 3, 4, 6 and 8; 4 was fastest by up to 1 %
# against 2 and 3, and 1 and 6 to 8 slower.
PIECES_PER_WARP = 4
ROW_FLOOR = _hub.DENSE_CT


def _t(x, dtype=torch.int32) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x)).to(dtype)


@dataclasses.dataclass(frozen=True)
class CombineTable:
    """Scatter-free segment-merge structure (binning.combine_tables).

    ``main`` is the [N, Km] position table covering all rows with <= Km
    partials; the few rows with more are -1 in ``main`` and their full
    lists live in the [V, K] ``ov`` table, merged separately and patched in
    by row id (``ov_rows``)."""

    main: torch.Tensor     # [N, Km] int32 positions, -1 padded
    ov_rows: torch.Tensor  # [V] int32 overflow row ids
    ov: torch.Tensor       # [V, K] int32 positions, -1 padded

    def to(self, device) -> "CombineTable":
        return CombineTable(main=self.main.to(device),
                            ov_rows=self.ov_rows.to(device),
                            ov=self.ov.to(device))


def split_budget(edges: int, warps: int) -> int:
    """Most edges a piece of a cut row holds: a block of ``edges`` edges
    over PIECES_PER_WARP x ``warps`` resident warps, at least ROW_FLOOR."""
    return max(ROW_FLOOR, math.ceil(edges / (PIECES_PER_WARP * max(warps, 1))))


def _row_edges(counts: np.ndarray, cp: np.ndarray) -> np.ndarray:
    """[R] int64 edges of each block row: its tile rows' over its chunk's
    entries (``counts`` [T, RT], ``cp`` the chunk_ptr)."""
    csum = np.concatenate([np.zeros((1, counts.shape[1]), np.int64),
                           np.cumsum(counts, axis=0, dtype=np.int64)])
    return (csum[cp[1:]] - csum[cp[:-1]]).reshape(-1)


def work_list(counts, chunk_ptr, budget: int):
    """The pieces the hub-block kernels walk, a warp a piece.

    ``counts``: [T, RT] edges of each (schedule entry, tile row);
    ``chunk_ptr``: [R / RT + 1] the entries of each row chunk.  A row whose
    edges fit ``budget`` is one piece, its chunk's entries whole; a longer
    row is cut at entry boundaries, greedily, into pieces of at most
    ``budget`` edges (one entry may exceed it alone).  Returns
    (pieces [P, 4], merge_rows [S], merge_ptr [S + 1]), int32: per piece in
    launch order, which is row order, (block row, first entry, end entry,
    partial slot), the slot -1 for a row of one piece, else the piece's row
    of the partials, numbered in launch order; the S rows cut, in order,
    and the slots of row i, merge_ptr[i]:merge_ptr[i + 1]."""
    counts = np.asarray(counts, np.int64)
    cp = np.asarray(chunk_ptr, np.int64)
    rt = counts.shape[1]
    totals = _row_edges(counts, cp)
    R = len(totals)
    chunk = np.arange(R) // rt
    first, end = cp[chunk], cp[chunk + 1]
    cuts = {}
    for r in np.flatnonzero(totals > budget).tolist():
        per = counts[first[r]:end[r], r % rt].tolist()
        at, acc = [int(first[r])], 0
        for i, n in enumerate(per):
            t = int(first[r]) + i
            if acc + n > budget and t > at[-1]:
                at.append(t)
                acc = 0
            acc += n
        at.append(int(end[r]))
        if len(at) > 2:
            cuts[r] = at
    n_pieces = np.ones(R, np.int64)
    for r, at in cuts.items():
        n_pieces[r] = len(at) - 1
    pieces = np.empty((int(n_pieces.sum()), 4), np.int32)
    at0 = np.concatenate([[0], np.cumsum(n_pieces)[:-1]])
    pieces[at0, 0] = np.arange(R)
    pieces[at0, 1] = first
    pieces[at0, 2] = end
    pieces[at0, 3] = -1
    slot = 0
    merge_ptr = [0]
    for r, at in cuts.items():  # row order: dicts keep insertion order
        k = len(at) - 1
        i = at0[r]
        pieces[i:i + k, 0] = r
        pieces[i:i + k, 1] = at[:-1]
        pieces[i:i + k, 2] = at[1:]
        pieces[i:i + k, 3] = np.arange(slot, slot + k)
        slot += k
        merge_ptr.append(slot)
    return (pieces, np.asarray(list(cuts), np.int32),
            np.asarray(merge_ptr, np.int32))


@dataclasses.dataclass(frozen=True)
class WorkList:
    """The pieces of a hub block that the MoNet kernels walk (``work_list``)
    and what they tell: ``budget`` edges at most a cut piece, the block's
    ``edges`` and the ``split_edges`` in rows cut into pieces."""

    pieces: torch.Tensor      # [P, 4] int32 row, entries [first, end), slot
    merge_rows: torch.Tensor  # [S] int32 block rows cut into pieces
    merge_ptr: torch.Tensor   # [S + 1] int32 their slots
    budget: int
    edges: int
    split_edges: int
    slots: int                # pieces of the rows cut: partials' rows

    @property
    def num_pieces(self) -> int:
        return int(self.pieces.shape[0])

    @property
    def split_rows(self) -> int:
        return int(self.merge_rows.shape[0])

    @property
    def split_share(self) -> float:
        """The share of the block's edges that run in rows cut into
        pieces."""
        return self.split_edges / self.edges if self.edges else 0.0

    @classmethod
    def build(cls, counts, chunk_ptr, budget: int) -> "WorkList | None":
        """The block's list for ``budget``, or None where no row is cut."""
        pieces, rows, ptr = work_list(counts, chunk_ptr, budget)
        if len(rows) == 0:
            return None
        per_row = _row_edges(np.asarray(counts),
                             np.asarray(chunk_ptr, np.int64))
        return cls(pieces=_t(pieces), merge_rows=_t(rows),
                   merge_ptr=_t(ptr), budget=int(budget),
                   edges=int(per_row.sum()),
                   split_edges=int(per_row[rows].sum()), slots=int(ptr[-1]))

    def to(self, device) -> "WorkList":
        return dataclasses.replace(
            self, pieces=self.pieces.to(device),
            merge_rows=self.merge_rows.to(device),
            merge_ptr=self.merge_ptr.to(device))


@dataclasses.dataclass(frozen=True)
class DenseBlock:
    """Tile-sparse dense hub block (hub.DensePlan) as tensors.

    Its per-row partials are appended AFTER every bin's segment partials and
    merged through the same combine table.  ``row_ids``/``col_ids`` are
    0-padded; padded rows have all-zero mask rows and are excluded from the
    combine table.  ``chunk_ptr`` is made from ``first``: the schedule
    entries of row chunk i are ``chunk_ptr[i]:chunk_ptr[i+1]``."""

    row_ids: torch.Tensor    # [Rpad] int32 graph row id per dense row
    col_ids: torch.Tensor    # [Cpad] int32 graph col id per block column
    mask: torch.Tensor       # [T, RT, CT//8] uint8 bit-plane packed
    rc: torch.Tensor         # [T] int32 row chunk per schedule entry
    ct: torch.Tensor         # [T] int32 col tile per schedule entry
    first: torch.Tensor      # [T] int32 1 iff first entry of its row chunk
    chunk_ptr: torch.Tensor  # [Rpad/RT + 1] int32
    num_rows: int            # real (unpadded) rows, a prefix of row_ids

    def to(self, device) -> "DenseBlock":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)
                     if f.name != "num_rows"})


def _dense_block(plan: _hub.DensePlan) -> DenseBlock:
    starts = np.flatnonzero(np.asarray(plan.first))
    chunk_ptr = np.append(starts, len(plan.first))
    return DenseBlock(row_ids=_t(plan.row_ids), col_ids=_t(plan.col_ids),
                      mask=_t(plan.mask, torch.uint8), rc=_t(plan.rc),
                      ct=_t(plan.ct), first=_t(plan.first),
                      chunk_ptr=_t(chunk_ptr), num_rows=int(plan.num_rows))


@dataclasses.dataclass(frozen=True)
class BinnedAdj:
    """Degree-binned adjacency (see binning.BinnedCSR) as tensors.

    ``cmb``: [num_rows, K] combine table — per row, the positions of its
    segment partials in the concatenated per-bin order, then the dense
    block's rows.  ``dense``: the hub block, or None.  ``epos``: the slot
    position of each CSR edge in the concatenated [S*W] slot order (only
    with edge tables and without a hub block, whose edges have no slot)."""

    nbr: tuple    # per bin: [S_b, W_b] int32
    edge: tuple   # per bin: [S_b, W_b] int32 global CSR edge id, or Nones
    row: tuple    # per bin: [S_b] int32
    count: tuple  # per bin: [S_b] int32
    cmb: CombineTable | None
    dense: DenseBlock | None
    epos: torch.Tensor | None  # [num_edges] int32, or None
    widths: tuple
    num_rows: int
    num_edges: int

    @property
    def num_bins(self) -> int:
        return len(self.widths)

    def bins(self):
        """Iterate (width, nbr, edge, row, count) per bin."""
        for b in range(self.num_bins):
            yield (self.widths[b], self.nbr[b], self.edge[b], self.row[b],
                   self.count[b])

    def segs(self):
        """The bins as the list wrappers of ops/bins.py take them: one
        (nbr, row, count) per bin."""
        return list(zip(self.nbr, self.row, self.count))

    def to(self, device) -> "BinnedAdj":
        def mv(xs):
            return tuple(None if x is None else x.to(device) for x in xs)

        return dataclasses.replace(
            self, nbr=mv(self.nbr), edge=mv(self.edge), row=mv(self.row),
            count=mv(self.count),
            cmb=None if self.cmb is None else self.cmb.to(device),
            dense=None if self.dense is None else self.dense.to(device),
            epos=None if self.epos is None else self.epos.to(device))


def from_binned(b: _binning.BinnedCSR, with_cmb: bool = True,
                with_edge: bool = True,
                dense: _hub.DensePlan | None = None) -> BinnedAdj:
    """Host BinnedCSR (and hub.DensePlan) -> BinnedAdj of CPU tensors.

    ``dense`` rows' partials are indexed AFTER every bin's segments in the
    combine table; only its first ``num_rows`` rows are valid.
    ``with_cmb=False`` builds no combine table (``cmb`` is None), for
    callers that stack tables of their own; the fused ops refuse such a
    graph.  ``with_edge=False`` omits the per-slot global-edge-id tables and
    the inverse slot-position table ``epos``, which is built only without a
    hub block."""
    epos = None
    if with_edge and dense is None:
        # inverse permutation: CSR edge id -> position in the concatenated
        # [S*W] slot order
        ep = np.full(b.num_edges, 0, np.int64)
        off = 0
        for bi in range(len(b.nbr)):
            e_t = np.asarray(b.edge[bi], np.int64)
            s, w = e_t.shape
            m = (np.arange(w)[None, :]
                 < np.asarray(b.count[bi])[:, None])
            pos = off + np.arange(s * w, dtype=np.int64).reshape(s, w)
            ep[e_t[m]] = pos[m]
            off += s * w
        if off > np.iinfo(np.int32).max:
            raise ValueError(
                f"padded slot count {off} overflows the int32 epos table")
        epos = _t(ep)
    cmb = None
    if with_cmb:
        rows_concat = [np.asarray(r) for r in b.row]
        valid = [np.asarray(c) > 0 for c in b.count]
        if dense is not None:
            rows_concat.append(np.asarray(dense.row_ids, np.int64))
            v = np.zeros(len(dense.row_ids), bool)
            v[:dense.num_rows] = True
            valid.append(v)
        main, ov_rows, ov = _binning.combine_tables(
            np.concatenate(rows_concat), b.num_rows, np.concatenate(valid))
        cmb = CombineTable(main=_t(main), ov_rows=_t(ov_rows), ov=_t(ov))
    return BinnedAdj(
        nbr=tuple(_t(x) for x in b.nbr),
        edge=(tuple(_t(x) for x in b.edge) if with_edge
              else (None,) * len(b.nbr)),
        row=tuple(_t(x) for x in b.row),
        count=tuple(_t(x) for x in b.count),
        cmb=cmb,
        dense=None if dense is None else _dense_block(dense),
        epos=epos,
        widths=b.widths,
        num_rows=b.num_rows,
        num_edges=b.num_edges,
    )


@dataclasses.dataclass(frozen=True)
class Graph:
    """Static-topology graph: CSR over destination rows, CSC transpose, the
    CSR->CSC edge permutation, and both binned layouts.  All indices
    int32."""

    row_ptr: torch.Tensor  # [N+1] int32
    col_ind: torch.Tensor  # [E]   int32 — source node of CSR edge e
    col_ptr: torch.Tensor  # [N+1] int32
    row_ind: torch.Tensor  # [E]   int32 — destination node of CSC slot j
    permute: torch.Tensor  # [E]   int32 — CSR edge id stored at CSC slot j
    fwd: BinnedAdj  # binned CSR: rows = destinations, slots = sources
    bwd: BinnedAdj  # binned CSC: rows = sources, slots = destinations
    num_nodes: int
    num_edges: int

    def in_degrees(self) -> torch.Tensor:
        """[N] int32 in-degree per node, from the raw CSR (so before
        ``slim()`` drops it)."""
        return torch.diff(self.row_ptr)

    def out_degrees(self) -> torch.Tensor:
        """[N] int32 out-degree per node, from the raw CSC (so before
        ``slim()`` drops it)."""
        return torch.diff(self.col_ptr)

    def slim(self) -> "Graph":
        """Graph with the raw CSR/CSC/permute arrays dropped (zero-length):
        the fused op reads only the binned layouts."""
        empty = torch.zeros((0,), dtype=torch.int32,
                            device=self.row_ptr.device)
        return dataclasses.replace(self, row_ptr=empty, col_ind=empty,
                                   col_ptr=empty, row_ind=empty,
                                   permute=empty)

    def to(self, device) -> "Graph":
        with span("dgnn.graph.to"):
            return dataclasses.replace(
                self, row_ptr=self.row_ptr.to(device),
                col_ind=self.col_ind.to(device),
                col_ptr=self.col_ptr.to(device),
                row_ind=self.row_ind.to(device),
                permute=self.permute.to(device),
                fwd=self.fwd.to(device), bwd=self.bwd.to(device))


def build_graph(
    src,
    dst,
    num_nodes: int,
    *,
    widths: Sequence[int] | None = None,
    self_loops: bool = True,
    dense: str | tuple | None = None,
    edge_tables: bool = True,
) -> Graph:
    """Host-side one-time preprocessing from a COO edge list (edge u->v means
    v aggregates u), with degree binning.  Same signature as
    ``dgnn_tpu.graph.structure.build_graph``.

    ``widths=None`` picks bin widths per direction from the degree histogram
    (binning.auto_widths).  ``dense``: route the hub-dominated core through
    the dense hub-block kernels; "auto" plans the block per direction with
    hub.plan_dense, an ``(R, C)`` tuple forces the top R rows by degree
    against the top C columns, None disables it."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if self_loops:
        src, dst = _build.remove_self_loops(src, dst)
        src, dst = _build.add_self_loops(src, dst, num_nodes)
    row_ptr, col_ind = _build.coo_to_csr(src, dst, num_nodes)
    col_ptr, row_ind, permute = _build.csr_to_csc_permute(row_ptr, col_ind)
    return build_graph_from_csr(row_ptr, col_ind, col_ptr, row_ind, permute,
                                widths=widths, dense=dense,
                                edge_tables=edge_tables)


def build_graph_from_csr(
    row_ptr,
    col_ind,
    col_ptr,
    row_ind,
    permute,
    *,
    widths: Sequence[int] | None = None,
    dense: str | tuple | None = None,
    edge_tables: bool = True,
) -> Graph:
    """build_graph from already-preprocessed CSR/CSC/permute arrays."""
    row_ptr = np.asarray(row_ptr, np.int64)
    col_ind = np.asarray(col_ind)
    col_ptr = np.asarray(col_ptr, np.int64)
    row_ind = np.asarray(row_ind)
    permute = np.asarray(permute)
    num_nodes = len(row_ptr) - 1

    if not (dense is None or dense == "auto" or isinstance(dense, tuple)):
        raise ValueError(f"dense must be None, 'auto' or (R, C): {dense!r}")

    def _one_dir(way, rp, ci, eids, opp_deg):
        """Plan and split off the dense block, bin the residual (spans
        named by the direction ``way``)."""
        plan = None
        sel = None
        if dense == "auto":
            with span(f"dgnn.graph.hub.plan.{way}"):
                sel = _hub.plan_dense(rp, ci, opp_deg)
        elif isinstance(dense, tuple):
            r, c = dense
            rows_by = np.argsort(np.diff(rp), kind="stable")[::-1][:r]
            cols_by = np.argsort(opp_deg, kind="stable")[::-1][:c]
            sel = (rows_by, cols_by, None)  # keep every tile
        if sel is not None:
            rows_sel, cols_sel, keep_tiles = sel
            if eids is None:
                eids = np.arange(len(ci), dtype=np.int64)
            with span(f"dgnn.graph.hub.fill.{way}"):
                plan, rp, ci, keep = _hub.build_dense_numpy(
                    rp, ci, rows_sel, cols_sel, keep_tiles)
            eids = eids[keep]
        w = widths if widths is not None else _binning.auto_widths(
            np.diff(rp))
        with span(f"dgnn.graph.bins.{way}"):
            binned = _binning.bin_csr(rp, ci, edge_ids=eids, widths=w)
            return from_binned(binned, with_edge=edge_tables, dense=plan)

    with span("dgnn.graph.build"):
        deg_in = np.diff(row_ptr)
        deg_out = np.diff(col_ptr)
        fwd = _one_dir("fwd", row_ptr, col_ind, None, deg_out)
        bwd = _one_dir("bwd", col_ptr, row_ind, permute, deg_in)
        return Graph(
            row_ptr=_t(row_ptr),
            col_ind=_t(col_ind),
            col_ptr=_t(col_ptr),
            row_ind=_t(row_ind),
            permute=_t(permute),
            fwd=fwd,
            bwd=bwd,
            num_nodes=int(num_nodes),
            num_edges=int(col_ind.shape[0]),
        )
