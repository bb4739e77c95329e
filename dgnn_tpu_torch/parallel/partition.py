"""Row-partitioned graph shards with static halo-exchange plans (host numpy).

Port of ``dgnn_tpu/parallel/partition.py``, array for array:

- Destination rows are partitioned into ``num_shards`` contiguous ranges of
  C padded rows (node p*C .. (p+1)*C-1 lives on shard p).
- Each shard stores its rows' edges with *remapped* source ids in an
  extended local space: [0, C) are the shard's own rows, C + q*Hmax + j is
  the j-th halo row received from shard q.
- The halo plan is a static [P, P, Hmax] table: ``send_ids[p, q]`` lists
  the local rows shard p sends to shard q each layer (0-padded), in the
  sorted order in which q's halo slots ask for them.  One all-to-all a
  layer moves exactly these rows (parallel/spmd.py).
- Edges are split into a *local* bin set (sources the shard owns) and a
  *halo* bin set over common widths; their partials merge through the
  same combine tables the single-device op uses.  ``dense=...`` gives
  each shard its own tile-sparse hub block per direction.
- ``ext_gids[p]`` maps extended id i to its GLOBAL node id, so the
  attention-dropout hash keys on global ids and a shard's mask is the
  single-device graph's, bit for bit.

Every shard's arrays are padded to the largest shard's and stacked on a
leading shard axis, as the JAX package stacks them for ``shard_map``; the
combine tables' positions count the pad segments and pad hub-block rows of
that layout, so ``shard_view`` hands rank p its slice of it unchanged.
The JAX package's half schedule of the hub block (``rc_h`` ... ``mt_h``)
is a TPU layout and is not built.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..graph import binning as _binning
from ..graph import build as _build
from ..graph import hub as _hub
from ..graph.structure import BinnedAdj, CombineTable, DenseBlock

__all__ = ["GraphShards", "ShardView", "StackedBins", "StackedCombine",
           "StackedDense", "partition_graph", "shard_view"]


@dataclasses.dataclass(frozen=True)
class StackedBins:
    """Every shard's bins over common widths, stacked: per bin [P, S, W]
    nbr / edge tables and [P, S] row / count tables, S the largest
    shard's segment count (pad segments: count 0, ids 0)."""

    nbr: tuple
    edge: tuple
    row: tuple
    count: tuple
    widths: tuple
    num_rows: int
    num_edges: int


@dataclasses.dataclass(frozen=True)
class StackedCombine:
    """Every shard's combine table (binning.combine_tables), stacked:
    main [P, N, Km], ov_rows [P, V], ov [P, V, K]; widths padded with -1
    and the overflow lists with idempotent entries (_stack_cmb)."""

    main: np.ndarray
    ov_rows: np.ndarray
    ov: np.ndarray


@dataclasses.dataclass(frozen=True)
class StackedDense:
    """Every shard's hub block of one direction, stacked: row_ids [P, R],
    col_ids [P, C], mask [P, T, RT, CT/8], rc / ct / first [P, T], padded
    to the largest shard's R, C and T (_stack_dense)."""

    row_ids: np.ndarray
    col_ids: np.ndarray
    mask: np.ndarray
    rc: np.ndarray
    ct: np.ndarray
    first: np.ndarray
    num_rows: int  # the padded R: per-shard row validity is in the tables


@dataclasses.dataclass(frozen=True)
class GraphShards:
    """Stacked per-shard graph data; leading axis = shard.

    fwd_local / fwd_halo: binned adjacency over local destination rows, with
    sources in the extended local index space ([C local] ++ [P*Hmax halo]).
    bwd: binned transpose over extended source rows.
    send_ids[p, q, Hmax]: local row ids shard p sends to shard q.
    edge_gids[p, e]: global CSR edge id of shard p's local edge e (lets
    per-edge data such as MoNet's pseudo-coordinates reshard:
    spmd.shard_edge_data).
    ext_gids[p, i]: global node id of extended id i (locals are p*C+i; a
    halo slot resolves through the peer's send list).
    fwd_cmb / bwd_cmb: combine tables over local bins ++ halo bins ++ hub
    rows (forward, local rows) and bins ++ hub rows (backward, extended
    rows).  fwd_dense / bwd_dense: the hub blocks, or None.
    halo_counts[p, q]: the rows of send_ids[p, q] that are real (the rest
    pad it to Hmax); not in the JAX container.
    """

    fwd_local: StackedBins
    fwd_halo: StackedBins
    bwd: StackedBins
    send_ids: np.ndarray   # [P, P, Hmax] int32
    halo_counts: np.ndarray  # [P, P] int64
    edge_gids: np.ndarray  # [P, Emax] int32
    ext_gids: np.ndarray   # [P, ext] int32
    fwd_cmb: StackedCombine
    bwd_cmb: StackedCombine
    fwd_dense: StackedDense | None
    bwd_dense: StackedDense | None
    num_shards: int
    nodes_per_shard: int
    halo_max: int
    num_nodes: int  # unpadded

    @property
    def padded_nodes(self) -> int:
        return self.num_shards * self.nodes_per_shard

    @property
    def ext_size(self) -> int:
        return self.nodes_per_shard + self.num_shards * self.halo_max


def _stack_binned(per_shard: Sequence[_binning.BinnedCSR], num_rows: int,
                  num_edges: int) -> StackedBins:
    """Stack per-shard BinnedCSR (same widths) padding segment counts."""
    widths = per_shard[0].widths
    assert all(b.widths == widths for b in per_shard)
    nbrs, edges, rows, counts = [], [], [], []
    for bi in range(len(widths)):
        smax = max(b.nbr[bi].shape[0] for b in per_shard)
        nb, eb, rb, cb = [], [], [], []
        for b in per_shard:
            pad = smax - b.nbr[bi].shape[0]
            nb.append(np.pad(b.nbr[bi], ((0, pad), (0, 0))))
            eb.append(np.pad(b.edge[bi], ((0, pad), (0, 0))))
            rb.append(np.pad(b.row[bi], (0, pad)))
            cb.append(np.pad(b.count[bi], (0, pad)))
        nbrs.append(np.stack(nb))
        edges.append(np.stack(eb))
        rows.append(np.stack(rb))
        counts.append(np.stack(cb))
    return StackedBins(nbr=tuple(nbrs), edge=tuple(edges), row=tuple(rows),
                       count=tuple(counts), widths=widths,
                       num_rows=num_rows, num_edges=num_edges)


def _bin_subset(row_ptr, col_ind, edge_ids, sel, num_rows, widths):
    """Bin only the edges selected by bool mask ``sel``, keeping row ids."""
    keep = np.nonzero(sel)[0]
    csr_row = np.repeat(np.arange(num_rows, dtype=np.int64),
                        np.diff(row_ptr).astype(np.int64))
    rows = csr_row[keep]
    counts = np.bincount(rows, minlength=num_rows)
    new_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=new_ptr[1:])
    return _binning.bin_csr(new_ptr, col_ind[keep].astype(np.int32),
                            edge_ids=edge_ids[keep], widths=widths,
                            keep_empty=True)


def _pad1(x, n, fill=0):
    x = np.asarray(x)
    if len(x) >= n:
        return x
    return np.concatenate([x, np.full(n - len(x), fill, x.dtype)])


def _stack_dense(plans: Sequence[_hub.DensePlan]) -> StackedDense:
    """Stack per-shard DensePlans into one block [P, ...].

    Schedules pad with no-op entries: rc = the shard's LAST row chunk, ct =
    0, first = 0, and a mask tile that is all zeros (mask storage is padded
    to the common tile count, so pad entry t reads zero tile t).  Padded
    row chunks and column tiles are named by no schedule entry; their
    output rows are excluded from the combine tables.
    """
    t_max = max(len(p.rc) for p in plans)
    r_max = max(len(p.row_ids) for p in plans)
    c_max = max(len(p.col_ids) for p in plans)
    rt, cb = plans[0].mask.shape[1], plans[0].mask.shape[2]
    masks, rcs, cts, firsts = [], [], [], []
    for p in plans:
        m = np.zeros((t_max, rt, cb), np.uint8)
        m[:len(p.rc)] = p.mask
        masks.append(m)
        rcs.append(_pad1(p.rc, t_max, fill=int(p.rc[-1])))
        cts.append(_pad1(p.ct, t_max))
        firsts.append(_pad1(p.first, t_max))
    return StackedDense(
        row_ids=np.stack([_pad1(p.row_ids, r_max) for p in plans]),
        col_ids=np.stack([_pad1(p.col_ids, c_max) for p in plans]),
        mask=np.stack(masks), rc=np.stack(rcs), ct=np.stack(cts),
        first=np.stack(firsts), num_rows=r_max)


def _shard_cmb(bin_sets: Sequence[_binning.BinnedCSR],
               targets: Sequence[Sequence[int]],
               plan: _hub.DensePlan | None, dense_rows: int, num_rows: int):
    """Per-shard combine table over the op's partial order: every bin of
    every bin set in sequence, then the hub-block rows.

    Positions index the STACKED layout, in which every bin is padded to the
    cross-shard max segment count (``targets``, matching _stack_binned) and
    the hub block to ``dense_rows`` (matching _stack_dense): pad segments
    and rows enter the position numbering but are marked invalid."""
    rows, valid = [], []
    for bs, tgt in zip(bin_sets, targets):
        for bi in range(bs.num_bins):
            r = np.asarray(bs.row[bi], np.int64)
            v = np.asarray(bs.count[bi]) > 0
            pad = tgt[bi] - len(r)
            rows.append(np.concatenate([r, np.zeros(pad, np.int64)]))
            valid.append(np.concatenate([v, np.zeros(pad, bool)]))
    if plan is not None:
        r = np.zeros(dense_rows, np.int64)
        r[:len(plan.row_ids)] = np.asarray(plan.row_ids, np.int64)
        v = np.zeros(dense_rows, bool)
        v[:plan.num_rows] = True
        rows.append(r)
        valid.append(v)
    return _binning.combine_tables(np.concatenate(rows), num_rows,
                                   np.concatenate(valid))


def _stack_cmb(cmbs) -> StackedCombine:
    """Stack per-shard (main, ov_rows, ov) combine tables, padding widths
    with -1 and the overflow list with idempotent entries: a pad overflow
    row re-merges a non-overflow row's exact main-table position list, so
    patching it in recomputes the value it already has."""
    km = max(m.shape[1] for m, _, _ in cmbs)
    vmax = max(len(r) for _, r, _ in cmbs)
    kov = max([o.shape[1] for _, _, o in cmbs if o.size] + [1])
    mains, rows_s, ovs = [], [], []
    for main, ov_rows, ov in cmbs:
        n, k = main.shape
        m = np.full((n, km), -1, np.int32)
        m[:, :k] = main
        mains.append(m)
        o = np.full((vmax, max(kov, km)), -1, np.int32)
        if ov.size:
            o[:len(ov_rows), :ov.shape[1]] = ov
        r = np.zeros(vmax, np.int32)
        r[:len(ov_rows)] = ov_rows
        if vmax > len(ov_rows):
            # idempotent padding: the smallest row NOT in ov_rows, with its
            # own main-table list (patch == what main already computed)
            in_ov = np.zeros(n, bool)
            in_ov[ov_rows] = True
            pad_row = int(np.nonzero(~in_ov)[0][0])
            r[len(ov_rows):] = pad_row
            o[len(ov_rows):, :km] = main[pad_row]
        rows_s.append(r)
        ovs.append(o)
    return StackedCombine(main=np.stack(mains), ov_rows=np.stack(rows_s),
                          ov=np.stack(ovs))


def partition_graph(src, dst, num_nodes: int, num_shards: int, *,
                    widths: Sequence[int] | None = None,
                    self_loops: bool = True,
                    dense: str | tuple | None = None) -> GraphShards:
    """Build row-partitioned shards + halo plan from a COO edge list (host).

    Same arguments as ``partition_graph`` of dgnn_tpu/parallel/partition.py.
    ``widths=None`` derives bin widths per DIRECTION from the combined
    POST-DENSE residual degree histograms across all shards (shards share
    one width set so their bin tables stack).  ``dense``: None, "auto"
    (hub.plan_dense per shard and direction) or an (R, C) forced block; a
    direction runs dense only if every shard has a plan."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if self_loops:
        src, dst = _build.remove_self_loops(src, dst)
        src, dst = _build.add_self_loops(src, dst, num_nodes)
    c = -(-num_nodes // num_shards)  # nodes per shard (padded space)

    row_ptr, col_ind = _build.coo_to_csr(src, dst, num_nodes)
    w_fwd = w_bwd = None if widths is None else tuple(widths)
    csr_row = np.repeat(np.arange(num_nodes, dtype=np.int64),
                        np.diff(row_ptr).astype(np.int64))
    owner_dst = csr_row // c
    owner_src = col_ind.astype(np.int64) // c

    # ---- halo plan (vectorized: one sort over the cross-shard edges)
    s = num_shards
    npad = s * c
    cross = owner_dst != owner_src
    key = owner_dst * s + owner_src  # [E] (consumer, producer) pair id
    combo = key.astype(np.int64) * npad + col_ind.astype(np.int64)
    uniq = np.unique(combo[cross])  # sorted: pair-major, then source id
    ukey = uniq // npad
    usrc = uniq % npad
    pair_start = np.searchsorted(ukey, np.arange(s * s + 1))
    pair_cnt = np.diff(pair_start)
    h_max = max(int(pair_cnt.max(initial=0)), 1)

    send_ids = np.zeros((s, s, h_max), np.int32)
    slot = np.arange(len(uniq)) - pair_start[ukey]
    # consumer p = ukey // s needs usrc from producer q = ukey % s
    send_ids[ukey % s, ukey // s, slot] = (usrc - (ukey % s) * c).astype(
        np.int32)

    # remap every cross edge's source to its halo slot in one pass
    remapped_all = col_ind.astype(np.int64) - owner_src * c  # local default
    if cross.any():
        idx = np.searchsorted(uniq, combo[cross])
        pos = idx - pair_start[ukey[idx]]
        remapped_all[cross] = c + owner_src[cross] * h_max + pos

    # ---- per-shard binned layouts (CSR order is row-sorted, so each
    # shard's edges are one contiguous slice)
    ext = c + num_shards * h_max
    shard_lo = np.searchsorted(owner_dst, np.arange(num_shards + 1))

    def _plan_dir(rp, ci, n_rows, n_cols, col_deg):
        """Hub-block tile selection for one direction of one shard."""
        if dense is None:
            return None
        if dense == "auto":
            return _hub.plan_dense(rp, ci, col_deg)
        r, cc = dense
        rows_by = np.argsort(np.diff(rp), kind="stable")[::-1]
        cols_by = np.argsort(col_deg, kind="stable")[::-1]
        return (rows_by[: min(int(r), n_rows)],
                cols_by[: min(int(cc), n_cols)], None)

    # phase 1: per-shard local CSR/CSC primitives + hub tile selections
    prims, fsels, bsels = [], [], []
    for p in range(num_shards):
        e_sel = np.arange(shard_lo[p], shard_lo[p + 1])
        rows_l = (csr_row[e_sel] - p * c).astype(np.int64)
        is_local = ~cross[e_sel]
        remapped = remapped_all[e_sel]
        # rebuild a local CSR over c rows; local edge ids = order within shard
        order = np.lexsort((remapped, rows_l))
        rows_s = rows_l[order]
        cols_s = remapped[order].astype(np.int32)
        loc_s = is_local[order]
        gids_s = e_sel[order]  # global CSR edge id per local edge
        counts = np.bincount(rows_s, minlength=c)
        lptr = np.zeros(c + 1, np.int64)
        np.cumsum(counts, out=lptr[1:])
        # transpose over extended sources for the backward pass
        order_t = np.lexsort((rows_s, cols_s))
        t_counts = np.bincount(cols_s, minlength=ext)
        tptr = np.zeros(ext + 1, np.int64)
        np.cumsum(t_counts, out=tptr[1:])
        prims.append((lptr, cols_s, loc_s, gids_s, rows_s, order_t, tptr))
        fsels.append(_plan_dir(lptr, cols_s, c, ext, t_counts))
        bsels.append(_plan_dir(tptr, rows_s[order_t], ext, c, counts))
    # a direction runs dense only if EVERY shard has a plan (the shards'
    # layouts must stack; a declined shard disables the direction)
    if any(sel is None for sel in fsels):
        fsels = [None] * num_shards
    if any(sel is None for sel in bsels):
        bsels = [None] * num_shards

    # phase 2a: per-shard hub residuals (before binning, so the bin widths
    # can come from the ACTUAL residual degrees)
    fres, bres, gids_b = [], [], []
    fplans, bplans = [], []
    for p in range(num_shards):
        lptr, cols_s, loc_s, gids_s, rows_s, order_t, tptr = prims[p]
        eids = np.arange(len(cols_s), dtype=np.int64)
        if fsels[p] is not None:
            fplan, f_ptr, f_cols, f_keep = _hub.build_dense_numpy(
                lptr, cols_s, fsels[p][0], fsels[p][1], fsels[p][2],
                num_cols=ext)
            fplans.append(fplan)
            fres.append((f_ptr, f_cols, f_keep, loc_s[f_keep]))
        else:
            fres.append((lptr, cols_s, eids, loc_s))
        t_cols = rows_s[order_t].astype(np.int32)
        eids_t = eids[order_t]
        if bsels[p] is not None:
            bplan, b_ptr, b_cols, b_keep = _hub.build_dense_numpy(
                tptr, t_cols, bsels[p][0], bsels[p][1], bsels[p][2],
                num_cols=c)
            bplans.append(bplan)
            bres.append((b_ptr, b_cols.astype(np.int32), eids_t[b_keep]))
        else:
            bres.append((tptr, t_cols, eids_t))
        gids_b.append(gids_s)

    if w_fwd is None:
        w_fwd = _binning.auto_widths(
            np.concatenate([np.diff(r[0]) for r in fres]))
        w_bwd = _binning.auto_widths(
            np.concatenate([np.diff(r[0]) for r in bres]))

    # phase 2b: bin every shard with the common widths
    fwd_local_b, fwd_halo_b, bwd_b = [], [], []
    for p in range(num_shards):
        f_ptr, f_cols, f_eids, loc_res = fres[p]
        fwd_local_b.append(
            _bin_subset(f_ptr, f_cols, f_eids, loc_res, c, w_fwd))
        fwd_halo_b.append(
            _bin_subset(f_ptr, f_cols, f_eids, ~loc_res, c, w_fwd))
        b_ptr, b_cols, b_eids = bres[p]
        bwd_b.append(_binning.bin_csr(b_ptr, b_cols, edge_ids=b_eids,
                                      widths=w_bwd, keep_empty=True))

    # combine tables index the STACKED (cross-shard padded) partial layout
    def _targets(bsets):
        return [max(b.nbr[bi].shape[0] for b in bsets)
                for bi in range(bsets[0].num_bins)]

    tl, th, tb = (_targets(fwd_local_b), _targets(fwd_halo_b),
                  _targets(bwd_b))
    fdr = max(len(p.row_ids) for p in fplans) if fplans else 0
    bdr = max(len(p.row_ids) for p in bplans) if bplans else 0
    fcmbs = [_shard_cmb([fwd_local_b[p], fwd_halo_b[p]], [tl, th],
                        fplans[p] if fplans else None, fdr, c)
             for p in range(num_shards)]
    bcmbs = [_shard_cmb([bwd_b[p]], [tb], bplans[p] if bplans else None,
                        bdr, ext)
             for p in range(num_shards)]

    e_max = max(b.num_edges for b in fwd_local_b + fwd_halo_b)
    g_max = max(len(g) for g in gids_b)
    gids = np.zeros((num_shards, g_max), np.int32)
    for p, g in enumerate(gids_b):
        gids[p, : len(g)] = g
    # global node id per extended id: locals are p*c+i; halo slot
    # c + q*h_max + j resolves through shard q's send list to shard p
    ext_gids = np.zeros((num_shards, ext), np.int64)
    ext_gids[:, :c] = (np.arange(num_shards)[:, None] * c
                       + np.arange(c)[None, :])
    for p in range(num_shards):
        ext_gids[p, c:] = (np.arange(num_shards)[:, None] * c
                           + send_ids[:, p, :]).reshape(-1)
    return GraphShards(
        fwd_local=_stack_binned(fwd_local_b, c, e_max),
        fwd_halo=_stack_binned(fwd_halo_b, c, e_max),
        bwd=_stack_binned(bwd_b, ext, e_max),
        send_ids=send_ids,
        # pair (consumer p, producer q) is pair_cnt[p * s + q]
        halo_counts=pair_cnt.reshape(s, s).T.copy(),
        edge_gids=gids,
        ext_gids=ext_gids.astype(np.int32),
        fwd_cmb=_stack_cmb(fcmbs),
        bwd_cmb=_stack_cmb(bcmbs),
        fwd_dense=_stack_dense(fplans) if fplans else None,
        bwd_dense=_stack_dense(bplans) if bplans else None,
        num_shards=num_shards,
        nodes_per_shard=c,
        halo_max=h_max,
        num_nodes=num_nodes,
    )


# ---------------------------------------------------------------------------
# One shard's tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardView:
    """Shard ``rank``'s slice of GraphShards as the ops take it.

    fwd: local bins ++ halo bins over the shard's C rows, with its combine
    table and hub block; bwd: the transpose over the C + P*Hmax extended
    rows.  send_ids [P, Hmax], ext_gids [ext], edge_gids [Emax]: the
    shard's rows of the stacked tables (int32)."""

    fwd: BinnedAdj
    bwd: BinnedAdj
    send_ids: torch.Tensor
    ext_gids: torch.Tensor
    edge_gids: torch.Tensor
    rank: int
    num_shards: int
    nodes_per_shard: int
    halo_max: int
    num_nodes: int

    @property
    def ext_size(self) -> int:
        return self.nodes_per_shard + self.num_shards * self.halo_max

    @property
    def rows(self) -> slice:
        """The shard's rows of the padded node space."""
        lo = self.rank * self.nodes_per_shard
        return slice(lo, lo + self.nodes_per_shard)

    def to(self, device) -> "ShardView":
        return dataclasses.replace(
            self, fwd=self.fwd.to(device), bwd=self.bwd.to(device),
            send_ids=self.send_ids.to(device),
            ext_gids=self.ext_gids.to(device),
            edge_gids=self.edge_gids.to(device))


def _t(x, dtype=torch.int32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _cmb_of(sc: StackedCombine, p: int) -> CombineTable:
    return CombineTable(main=_t(sc.main[p]), ov_rows=_t(sc.ov_rows[p]),
                        ov=_t(sc.ov[p]))


def _dense_of(sd: StackedDense | None, p: int) -> DenseBlock | None:
    """Shard p's hub block in the stacked layout.  chunk_ptr is taken from
    the schedule's row chunks: a pad entry (the last chunk's rc, a zero
    tile) joins the last chunk's range, and the row chunks past the
    shard's own (padding to the largest shard's rows) get empty ranges,
    for which the kernels and plain versions write empty partials (l = 0,
    acc = 0) that no combine table names."""
    if sd is None:
        return None
    rc = np.asarray(sd.rc[p], np.int64)
    n_chunks = sd.row_ids.shape[1] // _hub.DENSE_RT
    chunk_ptr = np.searchsorted(rc, np.arange(n_chunks + 1), side="left")
    return DenseBlock(row_ids=_t(sd.row_ids[p]), col_ids=_t(sd.col_ids[p]),
                      mask=_t(sd.mask[p], torch.uint8), rc=_t(sd.rc[p]),
                      ct=_t(sd.ct[p]), first=_t(sd.first[p]),
                      chunk_ptr=_t(chunk_ptr), num_rows=int(sd.num_rows))


def merge_binned(a: BinnedAdj, b: BinnedAdj, cmb=None,
                 dense=None) -> BinnedAdj:
    """Union of two bin sets over the same destination rows (the local and
    halo edge partitions), with ``cmb`` / ``dense`` the shard's combine
    table and hub block: the table's positions cover a's bins ++ b's bins
    ++ the block's rows, this adjacency's partial order."""
    assert a.num_rows == b.num_rows
    return BinnedAdj(nbr=a.nbr + b.nbr, edge=a.edge + b.edge,
                     row=a.row + b.row, count=a.count + b.count, cmb=cmb,
                     dense=dense, epos=None, widths=a.widths + b.widths,
                     num_rows=a.num_rows,
                     num_edges=a.num_edges + b.num_edges)


def _adj(sb: StackedBins, p: int) -> BinnedAdj:
    """Shard p's bins of one stacked bin set (no table, no block)."""
    def of(tables):
        return tuple(_t(x[p]) for x in tables)

    return BinnedAdj(nbr=of(sb.nbr), edge=of(sb.edge), row=of(sb.row),
                     count=of(sb.count), cmb=None, dense=None, epos=None,
                     widths=sb.widths, num_rows=sb.num_rows,
                     num_edges=sb.num_edges)


def shard_view(shards: GraphShards, p: int, device=None) -> ShardView:
    """Shard p's tensors (module docstring), on ``device`` (the CPU when
    None).  Keeps the stacked layout's pad segments and hub rows, so the
    combine tables apply as they are."""
    if not 0 <= p < shards.num_shards:
        raise ValueError(f"shard {p} of {shards.num_shards}")
    fwd = merge_binned(_adj(shards.fwd_local, p), _adj(shards.fwd_halo, p),
                       cmb=_cmb_of(shards.fwd_cmb, p),
                       dense=_dense_of(shards.fwd_dense, p))
    bwd = dataclasses.replace(_adj(shards.bwd, p),
                              cmb=_cmb_of(shards.bwd_cmb, p),
                              dense=_dense_of(shards.bwd_dense, p))
    view = ShardView(fwd=fwd, bwd=bwd, send_ids=_t(shards.send_ids[p]),
                     ext_gids=_t(shards.ext_gids[p]),
                     edge_gids=_t(shards.edge_gids[p]), rank=p,
                     num_shards=shards.num_shards,
                     nodes_per_shard=shards.nodes_per_shard,
                     halo_max=shards.halo_max, num_nodes=shards.num_nodes)
    return view if device is None else view.to(device)
