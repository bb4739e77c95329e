"""Standalone sparse primitives over the binned graph layout (port of
``dgnn_tpu/ops/primitives.py``).

``spmm``, ``sddmm``, ``edge_softmax`` and ``edge_transpose`` are flat
per-edge ops for composing layers beyond GAT, MoNet and EdgeConv.  Per-edge
data is [E, H] (or [E, H, ...]) in CSR edge order, node data [N, H, F].

``spmm`` and ``sddmm`` run over the binned layouts and are autograd
Functions whose backward passes are the same two primitives: the gradient
of an SpMM is an SpMM over the transposed (CSC) bins and an SDDMM; the
gradient of an SDDMM is two SpMMs.  A row's segments are merged through
the graph's combine table; an SDDMM's per-slot results are put in CSR
edge order through the inverse slot table ``epos``.  They need a graph
built with ``edge_tables=True`` and no hub block (``dense=None``): a hub
block's edges have no edge id, so a flat per-edge op over it would drop
them.  The JAX package computes these in XLA outside any Pallas kernel;
here they are torch ops (gathers, ``einsum``, ``scatter_reduce``) on
every device.
"""

from __future__ import annotations

import torch

from ..graph.structure import BinnedAdj, Graph
from .bins import _cat_rows
from .common import combine_sum, lane_mask

__all__ = ["spmm", "sddmm", "edge_softmax", "edge_transpose"]


def _spmm_adj(adj: BinnedAdj, weights, feat):
    """out[r, h, f] = sum over row r's slots of weights[edge, h] *
    feat[nbr, h, f], merged per row."""
    accs = []
    for w_, nbr, edge, _row, count in adj.bins():
        mask = lane_mask(count, w_)[..., None]
        w = torch.where(mask, weights[edge.long()], 0.0)   # [S, W, H]
        accs.append(torch.einsum("swh,swhf->shf", w, feat[nbr.long()]))
    return combine_sum(adj.cmb, _cat_rows(accs, feat.shape[1:], feat))


def _sddmm_adj(adj: BinnedAdj, lhs, rhs):
    """w[e, h] = <lhs[row(e), h], rhs[col(e), h]> in CSR edge order: per
    slot in the bins' concatenated slot order, reordered through the
    inverse slot table ``adj.epos``."""
    parts = []
    for w_, nbr, _e, row, count in adj.bins():
        mask = lane_mask(count, w_)[..., None]
        gw = torch.einsum("shf,swhf->swh", lhs[row.long()], rhs[nbr.long()])
        parts.append(torch.where(mask, gw, 0.0).reshape(-1, gw.shape[-1]))
    return torch.cat(parts)[adj.epos.long()]


class _SpMM(torch.autograd.Function):
    """out = SpMM(weights, feat) over the forward bins; the backward's
    d feat is the same SpMM over the backward bins (whose edge tables hold
    CSR edge ids) and its d weights a per-edge SDDMM."""

    @staticmethod
    def forward(ctx, weights, feat, graph):
        ctx.save_for_backward(weights, feat)
        ctx.graph = graph
        return _spmm_adj(graph.fwd, weights, feat)

    @staticmethod
    def backward(ctx, g_out):
        weights, feat = ctx.saved_tensors
        g = g_out.float().contiguous()
        need = ctx.needs_input_grad
        d_w = _sddmm_adj(ctx.graph.fwd, g, feat) if need[0] else None
        d_feat = _spmm_adj(ctx.graph.bwd, weights, g) if need[1] else None
        return d_w, d_feat, None


class _SDDMM(torch.autograd.Function):
    """w = SDDMM(lhs, rhs); the backward is two SpMMs: d lhs over the
    forward bins, d rhs over the backward bins."""

    @staticmethod
    def forward(ctx, lhs, rhs, graph):
        ctx.save_for_backward(lhs, rhs)
        ctx.graph = graph
        return _sddmm_adj(graph.fwd, lhs, rhs)

    @staticmethod
    def backward(ctx, g_out):
        lhs, rhs = ctx.saved_tensors
        g = g_out.float().contiguous()
        need = ctx.needs_input_grad
        d_lhs = _spmm_adj(ctx.graph.fwd, g, rhs) if need[0] else None
        d_rhs = _spmm_adj(ctx.graph.bwd, g, lhs) if need[1] else None
        return d_lhs, d_rhs, None


def _check_flat_graph(graph: Graph, what: str) -> None:
    """Refuse a graph that a flat per-edge op cannot run over: one with a
    hub block (its edges have no edge id), without edge tables, or without
    combine tables."""
    if graph.fwd.dense is not None or graph.bwd.dense is not None:
        raise ValueError(f"{what} needs a graph built with dense=None: a hub "
                         "block's edges have no edge id")
    if graph.fwd.epos is None or any(
            e is None for e in graph.fwd.edge + graph.bwd.edge):
        raise ValueError(f"{what} needs a graph built with edge_tables=True")
    if graph.fwd.cmb is None or graph.bwd.cmb is None:
        raise ValueError(f"{what} needs the graph's combine tables")


def spmm(graph: Graph, edge_weights, feat):
    """out[v] = sum over in-edges e = (u -> v) of edge_weights[e] * feat[u].

    edge_weights: [E, H] float32 in CSR edge order; feat: [N, H, F] float32
    -> out [N, H, F]."""
    _check_flat_graph(graph, "spmm")
    return _SpMM.apply(edge_weights, feat, graph)


def sddmm(graph: Graph, lhs, rhs):
    """w[e] = <lhs[dst(e)], rhs[src(e)]> per head, e in CSR order.

    lhs / rhs: [N, H, F] float32 -> [E, H]; single-head is H = 1."""
    _check_flat_graph(graph, "sddmm")
    return _SDDMM.apply(lhs, rhs, graph)


def edge_rows(graph: Graph) -> torch.Tensor:
    """[E] int64 destination row of each CSR edge, from the raw CSR."""
    if graph.row_ptr.shape[0] != graph.num_nodes + 1:
        raise ValueError("this op reads the raw CSR, which graph.slim() "
                         "dropped")
    return torch.repeat_interleave(
        torch.arange(graph.num_nodes, device=graph.row_ptr.device),
        torch.diff(graph.row_ptr).long(), output_size=graph.num_edges)


def segment_max(x, seg, n: int):
    """Per-segment max of x [E, ...] over seg [E] int64 -> [n, ...]; -inf
    where a segment is empty.  No gradient flows through it."""
    out = torch.full((n, *x.shape[1:]), float("-inf"), dtype=x.dtype,
                     device=x.device)
    idx = seg.view(-1, *([1] * (x.dim() - 1))).expand_as(x)
    return out.scatter_reduce(0, idx, x.detach(), "amax")


def segment_sum(x, seg, n: int):
    """Per-segment sum of x [E, ...] over seg [E] int64 -> [n, ...]."""
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add(0, seg, x)


def edge_softmax(graph: Graph, scores):
    """Softmax of per-edge scores over each destination's in-edges.

    scores: [E, H] in CSR order -> [E, H] normalised (an empty row's max is
    taken as 0).  Reads the raw CSR, so a slim graph is refused.  The
    row max only shifts the exponent, so no gradient flows through it."""
    row = edge_rows(graph)
    n = graph.num_nodes
    m = segment_max(scores, row, n)
    m = torch.where(torch.isneginf(m), 0.0, m)
    w = torch.exp(scores - m[row])
    l = segment_sum(w, row, n)
    return w / torch.clamp(l, min=1e-20)[row]


def edge_transpose(graph: Graph, edge_data):
    """Per-edge data from CSR order into CSC (transposed) order: CSC slot j
    holds CSR edge ``graph.permute[j]``."""
    if graph.permute.shape[0] != graph.num_edges:
        raise ValueError("edge_transpose reads graph.permute, which "
                         "graph.slim() dropped")
    return edge_data[graph.permute.long()]
