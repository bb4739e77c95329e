"""Fused MoNet/GMMConv aggregation in its three pseudo-coordinate modes.

Port of ``dgnn_tpu/ops/gmm.py``, each custom VJP a
``torch.autograd.Function``:

- ``gmm_aggregate_node``: node-derived pseudo-coordinates, the path of the
  bench and of reddit, through the bin and hub-block kernels (below);
- ``gmm_aggregate_binned``: raw per-edge pseudo-coordinates pre-binned into
  both directions' slot tables once per graph (``bin_pseudo``), the JAX
  CLI's path on the citation graphs;
- ``gmm_aggregate``: flat ``[E, D]`` pseudo-coordinates in CSR edge order,
  differentiable.

The last two reach no Pallas kernel in the JAX package (their passes are
XLA gathers and einsums), so here they are plain PyTorch on tensors, on
either device.

Node-derived pseudo-coordinates, per edge e = (u -> v) with K Gaussian
kernels:

    pseudo[e] = concat(src_scalars[u], dst_scalars[v])
    p[e]      = [tanh](pseudo[e] @ proj_weight + proj_bias)
    w[e, k]   = exp(-0.5 * sum_d ((p[e, d] - mu[k, d]) * inv_sigma[k, d])^2)
    out[v, k] = sum_{e into v} w[e, k] * feat[u, k]

The projection is separable, p_d = [tanh](alpha_d[u] + beta_d[v]) with
alpha = src_scalars @ proj_weight[:Ds] and beta = dst_scalars @
proj_weight[Ds:] + proj_bias, so no per-edge pseudo is ever materialized and
one training step makes exactly two edge-sized passes:

  forward  (CSR bins): per segment sum of w_k x[u, k], merged per row by
      ``combine_sum``;
  backward (CSC bins): per source dX, and per segment a stat row whose sum
      over segments gives the gradients of mu, inv_sigma, proj_bias and both
      halves of proj_weight.

The forward runs every bin of the CSR direction in one launch
(ops/bins.bin_gmm_node_fwd_list), the backward every bin of the CSC
direction in one launch (bin_gmm_node_bwd_list), and a graph's tile-sparse
hub block (graph.structure.DenseBlock) runs through ops/dense.dense_gmm_fwd
/ dense_gmm_bwd, whose per-row partials follow the bins'.  Each is a CUDA
kernel for CUDA tensors and its plain version for CPU tensors.  The
backward saves only its inputs and recomputes alpha, beta and the edge
weights.

``gather_dtype=torch.bfloat16`` stores the node path's gathered feature
rows as bf16 and rounds where the JAX op rounds: ``feat`` is cast to bf16
before the Function; the bins gather alpha rounded with the rows
(``dgnn_tpu/ops/gmm.py:408-409``); the backward gathers g, beta and dfeat
in bf16 (``:486-488``), reads the resident x rows in bf16 and returns
``d_feat`` rounded to bf16 (``:650``), which the cast's own gradient
widens.  The hub block takes the rounded tables as float32 values and
alpha unrounded, as the JAX op hands them to its dense kernels.  Sums and
the output stay float32.

Binned pseudo-coordinates: the forward walks the CSR bins, projects each
slot's raw pseudo (Linear + optional tanh), forms the K Gaussian weights
and sums w_k x[nbr]; the backward is one walk over the CSC bins that gives
dX and every parameter gradient (mu, inv_sigma, the projection) as sums
over the pass, as ``_gmm2_backward`` does.  Flat pseudo-coordinates: the
Gaussian weights of every edge, an SpMM over the forward bins
(ops/primitives.py's ``spmm`` Function); its
backward is the same SpMM over the backward bins for dX and a per-edge
SDDMM reordered through the bins' ``epos`` table for the weights, through
which autograd gives d pseudo, d mu and d inv_sigma.

``gmm_node_fused`` and ``gmm_binned_fused`` are the node and binned ops
over an (adj_fwd, adj_bwd) pair whose destination and source spaces may
differ (a graph shard of parallel/partition.py), as the JAX package's
``_gmm_node`` and ``_gmm2`` are; ``gmm_aggregate_node`` and
``gmm_aggregate_binned`` are those ops over a Graph's two layouts.  The
binned op also takes layouts without combine tables: their segments are
then summed into their rows by ``index_add_``, as the JAX op's
``segment_sum`` does.
"""

from __future__ import annotations

import typing

import torch

from ..graph.structure import BinnedAdj, Graph
from .bins import _cat_rows, bin_gmm_node_bwd_list, bin_gmm_node_fwd_list
from .common import (combine_sum, gather_type, gaussian_terms, lane_mask,
                     rounded)
from .dense import DENSE_DTYPES, dense_gmm_bwd, dense_gmm_fwd
from .primitives import _SpMM

__all__ = ["NodePseudo", "gaussian_weights", "gmm_aggregate_node",
           "gmm_node_fused", "gmm_aggregate_binned", "gmm_binned_fused",
           "gmm_aggregate", "bin_edge_data", "bin_pseudo"]


class NodePseudo(typing.NamedTuple):
    """Per-node pseudo-coordinate sources for ``gmm_aggregate_node``:
    pseudo[e = (u -> v)] = concat(src[u], dst[v]).  The citation protocol
    takes 1 / sqrt(in-degree) as an [N, 1] column for both."""

    src: torch.Tensor  # [N, Ds]
    dst: torch.Tensor  # [N, Dd]


def gaussian_weights(pseudo, mu, inv_sigma):
    """[..., D], [K, D], [K, D] -> [..., K] Gaussian kernel weights."""
    return gaussian_terms(pseudo, mu, inv_sigma)[2]


def _project(sfeat, dfeat, pw_s, pw_d, pbias):
    """Per-node halves of the projected pseudo-coordinate (plain matmuls)."""
    alpha = (sfeat.float() @ pw_s).contiguous()
    beta = (dfeat.float() @ pw_d + pbias).contiguous()
    return alpha, beta


def _node_forward(adj: BinnedAdj, alpha, beta, feat, mu, isig, use_tanh,
                  dense_dtype):
    """CSR pass over ``adj``'s bins and hub block, merged through its
    combine table: out[v] = sum_u w(alpha[u], beta[v]) * feat[u].  ``feat``
    is float32 or bf16 (the gathered rows' type; the bins then read alpha
    rounded to it)."""
    tail = None
    if adj.dense is not None:
        # the block's rows follow every bin's
        tail = dense_gmm_fwd(adj.dense, beta, alpha, feat.float(), mu, isig,
                             use_tanh=use_tanh, dense_dtype=dense_dtype)
    acc = bin_gmm_node_fwd_list(feat, rounded(alpha, feat.dtype), beta,
                                adj.segs(), mu, isig, use_tanh=use_tanh,
                                tail=tail)
    return combine_sum(adj.cmb, acc)


def _node_backward(adj_bwd: BinnedAdj, alpha, beta, sfeat, dfeat, feat, mu,
                   isig, use_tanh, dense_dtype, g):
    """Single CSC pass: dX per source, and the parameter gradients as sums
    of the kernels' stat rows (layout: bins.bin_gmm_node_bwd).  ``feat``
    is float32 or bf16 (the gathered rows' type: g, beta and dfeat are
    gathered in it).  Returns (d_feat, d_mu, d_isig, d_pbias, d_pw_s,
    d_pw_d)."""
    K, D = mu.shape
    KD = K * D
    Dd, Ds = dfeat.shape[1], sfeat.shape[1]
    cut = 2 * KD + D + D * Dd  # where the bins' sfeat block starts
    dt = feat.dtype
    g = g.to(dt).contiguous()
    beta, dfeat = rounded(beta, dt), rounded(dfeat, dt)
    db = adj_bwd.dense
    dx_tail = None
    if db is not None:
        dx_tail, st_db = dense_gmm_bwd(db, g.float(), beta, dfeat, alpha,
                                       feat.float(), mu, isig,
                                       use_tanh=use_tanh,
                                       dense_dtype=dense_dtype)
    dx, st = bin_gmm_node_bwd_list(g, beta, dfeat, alpha, feat, sfeat,
                                   adj_bwd.segs(), mu, isig,
                                   use_tanh=use_tanh, dx_tail=dx_tail)
    tot = st.sum(dim=0)
    st_sum, d_pws = tot[:cut], tot[cut:].reshape(D, Ds).T
    if db is not None:
        # padded block rows carry no edge; their stats are zeroed all the same
        valid = torch.arange(db.row_ids.shape[0],
                             device=g.device) < db.num_rows
        st_db = torch.where(valid[:, None], st_db, 0.0)
        st_sum = st_sum + st_db.sum(dim=0)
        # the block's stat row has no sfeat block: the rows' sum of dpre
        # times their own raw source scalars
        rs = st_db[:, 2 * KD:2 * KD + D]
        d_pws = d_pws + sfeat[db.row_ids.long()].T @ rs
    d_feat = combine_sum(adj_bwd.cmb, dx).to(dt)
    d_mu = st_sum[:KD].reshape(K, D) * isig
    d_isig = -st_sum[KD:2 * KD].reshape(K, D)
    d_pb = st_sum[2 * KD:2 * KD + D]
    d_pwd = st_sum[2 * KD + D:].reshape(D, Dd).T
    return d_feat, d_mu, d_isig, d_pb, d_pws, d_pwd


class _GMMNode(torch.autograd.Function):
    """CSR pass forward; one CSC pass backward.  src/dst scalars take no
    gradient."""

    @staticmethod
    def forward(ctx, sfeat, dfeat, feat, pw_s, pw_d, pbias, mu, isig,
                adj_fwd, adj_bwd, use_tanh, dense_dtype):
        alpha, beta = _project(sfeat, dfeat, pw_s, pw_d, pbias)
        out = _node_forward(adj_fwd, alpha, beta, feat, mu, isig, use_tanh,
                            dense_dtype)
        ctx.save_for_backward(sfeat, dfeat, feat, pw_s, pw_d, pbias, mu, isig)
        ctx.adj_bwd, ctx.use_tanh = adj_bwd, use_tanh
        ctx.dense_dtype = dense_dtype
        return out

    @staticmethod
    def backward(ctx, g_out):
        sfeat, dfeat, feat, pw_s, pw_d, pbias, mu, isig = ctx.saved_tensors
        alpha, beta = _project(sfeat, dfeat, pw_s, pw_d, pbias)
        d_feat, d_mu, d_isig, d_pb, d_pws, d_pwd = _node_backward(
            ctx.adj_bwd, alpha, beta, sfeat.float().contiguous(),
            dfeat.float().contiguous(), feat, mu, isig, ctx.use_tanh,
            ctx.dense_dtype, g_out.float().contiguous())
        need = ctx.needs_input_grad
        grads = (None, None, d_feat, d_pws, d_pwd, d_pb, d_mu, d_isig)
        return tuple(g if n else None for g, n in zip(grads, need)) + (
            None,) * 4


def gmm_aggregate_node(graph: Graph, feat, src_scalars, dst_scalars, mu,
                       inv_sigma, *, proj_weight, proj_bias,
                       use_tanh: bool = True, dense_dtype: str = "bfloat16",
                       gather_dtype=None):
    """Fused MoNet aggregation with node-derived pseudo-coordinates.

    Args:
      graph: Graph (graph.structure.build_graph) on the tensors' device.
      feat: [N, K, F] float32 node features (K Gaussian kernels).
      src_scalars: [N, Ds], dst_scalars: [N, Dd] per-node pseudo sources
        (not differentiated, e.g. 1 / sqrt(degree)).
      mu, inv_sigma: [K, D] float32 kernel means and inverse widths.
      proj_weight: [Ds + Dd, D], proj_bias: [D] float32: the pseudo
        projection, applied inside the op so that its gradient is a global
        sum of the backward pass.
      use_tanh: tanh on the projected coordinates.
      dense_dtype: operand precision of the hub block's products:
        "bfloat16" (the default, as the JAX op) rounds them to bf16 and sums
        in float32; "float32" is exact.  Unused without a hub block.
      gather_dtype: None (float32) or ``torch.bfloat16`` (also
        "bfloat16"): the storage type of the gathered feature rows in both
        passes, rounded as the module docstring says; sums stay float32.
    Returns:
      [N, K, F] float32 (the caller sums over K).

    When no input needs a gradient (inference, or under ``torch.no_grad``),
    the forward saves nothing.
    """
    return gmm_node_fused(graph.fwd, graph.bwd, feat, src_scalars,
                          dst_scalars, mu, inv_sigma, proj_weight=proj_weight,
                          proj_bias=proj_bias, use_tanh=use_tanh,
                          dense_dtype=dense_dtype, gather_dtype=gather_dtype)


def gmm_node_fused(adj_fwd: BinnedAdj, adj_bwd: BinnedAdj, feat, src_scalars,
                   dst_scalars, mu, inv_sigma, *, proj_weight, proj_bias,
                   use_tanh: bool = True, dense_dtype: str = "bfloat16",
                   gather_dtype=None):
    """``gmm_aggregate_node`` over an adjacency pair whose destination and
    source spaces may differ: adj_fwd's rows are the Nd destinations,
    adj_bwd's the Ns sources; feat [Ns, K, F] and src_scalars [Ns, Ds] are
    source tables, dst_scalars [Nd, Dd] a destination table.  Returns
    [Nd, K, F]."""
    rows = gather_type(gather_dtype)
    if dense_dtype not in DENSE_DTYPES:
        raise ValueError(f"dense_dtype must be one of {DENSE_DTYPES}, got "
                         f"{dense_dtype!r}")
    if adj_fwd.cmb is None or adj_bwd.cmb is None:
        raise ValueError("gmm_aggregate_node needs the graph's combine tables")
    ds = src_scalars.shape[-1]
    if proj_weight.shape[0] != ds + dst_scalars.shape[-1]:
        raise ValueError(
            f"proj_weight has {proj_weight.shape[0]} rows for Ds + Dd = "
            f"{ds} + {dst_scalars.shape[-1]} pseudo scalars")
    for name, t in (("feat", feat), ("mu", mu), ("inv_sigma", inv_sigma),
                    ("proj_weight", proj_weight), ("proj_bias", proj_bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    # sliced out here so that autograd joins the two halves' gradients
    pw_s, pw_d = proj_weight[:ds], proj_weight[ds:]
    # the gathered rows' type; the cast's own gradient widens d_feat
    x = feat.to(rows).contiguous()
    mu, isig = mu.contiguous(), inv_sigma.contiguous()
    diff = (x, pw_s, pw_d, proj_bias, mu, isig)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in diff)):
        alpha, beta = _project(src_scalars, dst_scalars, pw_s, pw_d,
                               proj_bias)
        return _node_forward(adj_fwd, alpha, beta, x, mu, isig,
                             bool(use_tanh), dense_dtype)
    return _GMMNode.apply(src_scalars, dst_scalars, x, pw_s, pw_d, proj_bias,
                          mu, isig, adj_fwd, adj_bwd, bool(use_tanh),
                          dense_dtype)


# ---------------------------------------------------------------------------
# Binned pseudo-coordinates: raw per-edge tables in both slot layouts
# ---------------------------------------------------------------------------


def bin_edge_data(adj: BinnedAdj, data):
    """Flat per-edge data [E, ...] (CSR edge order) into ``adj``'s slot
    tables, one [S_b, W_b, ...] tensor a bin.  Needs the bins' edge tables
    (a graph built with ``edge_tables=True``); padded slots take the data
    of the edge their table names there, which no pass reads."""
    if any(e is None for e in adj.edge):
        raise ValueError("bin_edge_data needs a graph built with "
                         "edge_tables=True")
    return tuple(data[e.long()] for e in adj.edge)


def bin_pseudo(graph: Graph, pseudo):
    """Raw [E, Din] pseudo-coordinates pre-binned into both layouts, once a
    graph: (forward tables, backward tables)."""
    return (bin_edge_data(graph.fwd, pseudo),
            bin_edge_data(graph.bwd, pseudo))


def _merge_segments(adj: BinnedAdj, parts, like):
    """The bins' per-segment rows summed into ``adj``'s rows: through its
    combine table, or without one by ``index_add_`` over the segments'
    row ids (pad segments are all zero)."""
    vals = _cat_rows(parts, like.shape[1:], like)
    if adj.cmb is not None:
        return combine_sum(adj.cmb, vals)
    rows = torch.cat([r.long() for r in adj.row])
    out = torch.zeros((adj.num_rows,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, rows, vals)


def _project_slots(praw, pw, pbias, use_tanh):
    """[S, W, Din] raw slots -> [S, W, D] projected coordinates."""
    p = praw.float() @ pw + pbias
    return torch.tanh(p) if use_tanh else p


def _binned_forward(adj: BinnedAdj, tables, feat, pw, pbias, mu, isig,
                    use_tanh):
    """CSR pass: per slot the projected pseudo and its K Gaussian weights,
    the weighted sum of feat[nbr] a segment, merged per row."""
    accs = []
    for (w_, nbr, _e, _row, count), praw in zip(adj.bins(), tables):
        mask = lane_mask(count, w_)
        p = _project_slots(praw, pw, pbias, use_tanh)
        w = torch.where(mask[..., None], gaussian_terms(p, mu, isig)[2], 0.0)
        accs.append(torch.einsum("swk,swkf->skf", w, feat[nbr.long()]))
    return _merge_segments(adj, accs, feat)


def _binned_backward(adj_bwd: BinnedAdj, tables, feat, pw, pbias, mu, isig,
                     use_tanh, g_out):
    """One CSC pass (rows = sources, slots = destinations): dX per source,
    and the gradients of mu, inv_sigma, the projection weight and bias as
    sums over every slot.  Returns (d_feat, d_pw, d_pbias, d_mu, d_isig)."""
    d_mu = torch.zeros_like(mu)
    d_isig = torch.zeros_like(isig)
    d_pw = torch.zeros_like(pw)
    d_pb = torch.zeros_like(pbias)
    dxs = []
    for (w_, nbr, _e, row, count), praw in zip(adj_bwd.bins(), tables):
        mask = lane_mask(count, w_)[..., None]            # [S, W, 1]
        praw = praw.float()
        p = _project_slots(praw, pw, pbias, use_tanh)     # [S, W, D]
        diff, t, w = gaussian_terms(p, mu, isig)          # [S, W, K, D], [S, W, K]
        w = torch.where(mask, w, 0.0)
        g = g_out[nbr.long()]                             # [S, W, K, F]
        dxs.append(torch.einsum("swk,swkf->skf", w, g))
        # c = <x_u, g_v> w per kernel: d w / d mu = w t isig, d w / d isig =
        # -w t (p - mu), d w / d p = -w t isig
        c = torch.einsum("skf,swkf->swk", feat[row.long()], g) * w
        ct = c[..., None] * t                             # [S, W, K, D]
        d_mu = d_mu + ct.sum(dim=(0, 1)) * isig
        d_isig = d_isig - (ct * diff).sum(dim=(0, 1))
        dpre = -(ct * isig).sum(dim=2)                    # [S, W, D]
        if use_tanh:
            dpre = dpre * (1.0 - p * p)
        d_pb = d_pb + dpre.sum(dim=(0, 1))
        d_pw = d_pw + torch.einsum("swr,swd->rd", praw, dpre)
    d_feat = _merge_segments(adj_bwd, dxs, feat)
    return d_feat, d_pw, d_pb, d_mu, d_isig


class _GMMBinned(torch.autograd.Function):
    """CSR pass forward; one CSC pass backward.  The pseudo tables take no
    gradient."""

    @staticmethod
    def forward(ctx, feat, pw, pbias, mu, isig, adj_fwd, adj_bwd, tables,
                use_tanh):
        out = _binned_forward(adj_fwd, tables[0], feat, pw, pbias, mu, isig,
                              use_tanh)
        ctx.save_for_backward(feat, pw, pbias, mu, isig)
        ctx.adj_bwd, ctx.tables, ctx.use_tanh = adj_bwd, tables, use_tanh
        return out

    @staticmethod
    def backward(ctx, g_out):
        feat, pw, pbias, mu, isig = ctx.saved_tensors
        grads = _binned_backward(ctx.adj_bwd, ctx.tables[1], feat, pw,
                                 pbias, mu, isig, ctx.use_tanh,
                                 g_out.float().contiguous())
        need = ctx.needs_input_grad
        return tuple(g if n else None for g, n in zip(grads, need)) + (
            None,) * 4


def gmm_aggregate_binned(graph: Graph, feat, pseudo_bins, mu, inv_sigma, *,
                         proj_weight=None, proj_bias=None,
                         use_tanh: bool = True):
    """Fused MoNet aggregation over pre-binned raw pseudo-coordinates.

    Args:
      graph: Graph (graph.structure.build_graph) with the combine tables.
      feat: [N, K, F] float32 node features.
      pseudo_bins: (forward tables, backward tables) from ``bin_pseudo`` (no
        gradient flows into them; learn pseudo through ``gmm_aggregate``).
      mu, inv_sigma: [K, D] float32 kernel means and inverse widths.
      proj_weight: [Din, D], proj_bias: [D]: the projection Linear(Din, D)
        [+ tanh] applied to every slot inside the op; the identity (and no
        tanh) when proj_weight is None, a zero bias when proj_bias is None.
      use_tanh: tanh on the projected coordinates.
    Returns:
      [N, K, F] float32 (the caller sums over K).
    """
    if graph.fwd.cmb is None or graph.bwd.cmb is None:
        raise ValueError("gmm_aggregate_binned needs the graph's combine "
                         "tables")
    return gmm_binned_fused(graph.fwd, graph.bwd, feat, pseudo_bins, mu,
                            inv_sigma, proj_weight=proj_weight,
                            proj_bias=proj_bias, use_tanh=use_tanh)


def gmm_binned_fused(adj_fwd: BinnedAdj, adj_bwd: BinnedAdj, feat,
                     pseudo_bins, mu, inv_sigma, *, proj_weight=None,
                     proj_bias=None, use_tanh: bool = True):
    """``gmm_aggregate_binned`` over an adjacency pair whose destination
    and source spaces may differ (feat [Ns, K, F], result [Nd, K, F]).  A
    layout without a combine table sums its segments by row id; a hub
    block, which holds no slot tables, is not read (as the JAX op's)."""
    fwd_tables, bwd_tables = pseudo_bins
    if len(fwd_tables) != adj_fwd.num_bins \
            or len(bwd_tables) != adj_bwd.num_bins:
        raise ValueError("pseudo_bins do not match the graph's bins "
                         "(make them with bin_pseudo on this graph)")
    D = mu.shape[1]
    if proj_weight is None:
        din = fwd_tables[0].shape[-1] if fwd_tables else D
        proj_weight = torch.eye(din, D, dtype=torch.float32,
                                device=mu.device)
        proj_bias = torch.zeros(D, dtype=torch.float32, device=mu.device)
        use_tanh = False
    if proj_bias is None:
        proj_bias = torch.zeros(D, dtype=torch.float32, device=mu.device)
    return _GMMBinned.apply(feat.float().contiguous(), proj_weight,
                            proj_bias, mu, inv_sigma, adj_fwd, adj_bwd,
                            (tuple(fwd_tables), tuple(bwd_tables)),
                            bool(use_tanh))


# ---------------------------------------------------------------------------
# Flat pseudo-coordinates [E, D] in CSR edge order
# ---------------------------------------------------------------------------


def gmm_aggregate(graph: Graph, feat, pseudo, mu, inv_sigma):
    """Fused MoNet aggregation over flat pseudo-coordinates (differentiable
    in pseudo, mu and inv_sigma).

    Args:
      graph: Graph built with ``edge_tables=True`` and no hub block (the
        SDDMM reorders through the forward bins' ``epos``).
      feat: [N, K, F] float32 node features.
      pseudo: [E, D] float32 pseudo-coordinates in CSR edge order.
      mu, inv_sigma: [K, D] float32 kernel means and inverse widths.
    Returns:
      [N, K, F] float32 (the caller sums over K).
    """
    if graph.fwd.epos is None or any(
            e is None for e in graph.fwd.edge + graph.bwd.edge):
        raise ValueError("flat-pseudo GMM needs a graph built with "
                         "edge_tables=True")
    if graph.fwd.cmb is None or graph.bwd.cmb is None:
        raise ValueError("gmm_aggregate needs the graph's combine tables")
    w_flat = gaussian_weights(pseudo, mu, inv_sigma)
    return _SpMM.apply(w_flat, feat.float().contiguous(), graph)
