"""Fused multi-head GAT aggregation: score -> edge softmax -> weighted sum.

Port of ``dgnn_tpu/ops/gat.py`` (``gat_aggregate`` and its custom VJP,
``_gat_fused`` / ``_gat_fused_fwd`` / ``_gat_fused_bwd``) as a
``torch.autograd.Function``.  One training step makes exactly two
edge-sized passes:

  pass A (forward, CSR bins): per segment (m, l, acc) plus the sign-split
      partials (lpos, accpos) restricted to raw score >= 0, merged per row
      by a log-sum-exp combine into out, M, L, out_pos = sum_{s>=0} a^ x
      and r = sum_{s>=0} a;
  pass B (backward, CSC bins): per source, dX and d attn_col.

The per-destination half of softmax backward is closed-form over pass-A
residuals (no third pass):
    ws   = <g, out>
    t1   = <g, slope * out + (1 - slope) * out_pos>
    t2   = slope + (1 - slope) * r
    d_ar = t1 - ws * t2
The backward saves only M, L, out, out_pos, r (and the inputs) and
recomputes per-edge attention in pass B.  Attention dropout is re-derived
from (seed, dst, src, head) by ops/common.pair_keep's hash in both passes.
The seed is a Python int or a one-element integer tensor on the op's
device; the kernels read it from device memory, and the Function keeps the
tensor (never a host copy) for pass B, so a training step that draws its
seeds on the card can be captured into a CUDA graph and replayed with new
seeds every step (utils/timing.py).

``gather_dtype=torch.bfloat16`` stores the gathered feature rows as bf16,
as the JAX op does (``dgnn_tpu/ops/gat.py:505-509``), and rounds where it
rounds: the op casts ``feat`` to bf16 before the Function, so the forward
gathers bf16 rows of x and the bf16-rounded ``ac`` column beside them
(``_concat_rows(feat, ac)``); the backward casts ``g`` to bf16 before the
closed-form ws / t1 / d_ar, reads the resident x rows in bf16, and returns
``d_feat`` rounded to bf16, which the cast's own gradient widens.  The
destination columns the backward reads per edge, ``ar``, ``M``, ``Linv``
and ``ws``, stay float32 tables here, where the JAX op narrows them with
the gathered rows: M rounded to bf16 errs by up to |M| 2^-9 in the
exponent of every weight of its row, and ws rounded breaks the
cancellation in d ac's terms a (<x, g> - ws): on the Reddit stand-in the
gradients then strayed from float32's as far as fp8 operands put them
(PERF.md).  The hub
block takes the tables as float32 values and ``ac`` unrounded, as the JAX
op hands them to its dense kernels.  Every sum and the output stay
float32.

Pass A runs every bin of the CSR direction in one launch
(ops/bins.bin_gat_fwd_list), pass B every bin of the CSC direction in one
launch (bin_gat_bwd_list), and a graph's tile-sparse hub block
(graph.structure.DenseBlock) runs through ops/dense.dense_gat_fwd /
dense_gat_bwd, whose per-row partials follow the bins' and are merged
through the same combine tables.  Each is a CUDA kernel for CUDA tensors
and its plain version for CPU tensors.

``gat_fused`` is the op over an (adj_fwd, adj_bwd) pair whose destination
and source spaces may differ (a graph shard of parallel/partition.py:
destinations are the shard's rows, sources its rows and the halo rows it
receives), as ``dgnn_tpu/ops/gat.py:_gat_fused`` is; its ``gid`` table
maps both spaces to global node ids for the dropout hash (ops/bins.py).
``gat_aggregate`` is that op over a Graph's two layouts.
"""

from __future__ import annotations

import torch

from ..graph.structure import BinnedAdj, Graph
from .bins import bin_gat_bwd_list, bin_gat_fwd_list
from .common import (check_seed, combine_lse, combine_sum, gather_type,
                     rounded)
from .dense import DENSE_DTYPES, dense_gat_bwd, dense_gat_fwd

__all__ = ["gat_aggregate", "gat_fused"]


def _gat_forward(adj: BinnedAdj, ar, ac, feat, slope, p, seed, dense_dtype,
                 with_pos=True, gid=None):
    """Pass A over ``adj``'s bins and hub block, merged through its combine
    table.  ``feat`` is float32 or bf16 (the gathered rows' type; the bins
    then read ``ac`` rounded to it).  ``gid``: the dropout hash's id table,
    or None.  Returns (out, M, L, out_pos, r); out_pos and r are None
    unless ``with_pos``."""
    tail = None
    if adj.dense is not None:
        # the block's partials follow every bin's, each row's relative to
        # its exact maximum over its block edges, as a bin segment's are
        tail = dense_gat_fwd(adj.dense, ar, ac, feat.float(), slope=slope,
                             with_pos=with_pos, p=p, seed=seed,
                             dense_dtype=dense_dtype, gid=gid)
    m, l, lpos, acc, accpos = bin_gat_fwd_list(
        feat, rounded(ac, feat.dtype), ar, adj.segs(), slope=slope,
        with_pos=with_pos, p=p, seed=seed, tail=tail, gid=gid)
    parts = [l, acc] + ([lpos, accpos] if with_pos else [])
    M, merged = combine_lse(adj.cmb, m, parts)
    L = merged[0]
    Linv = 1.0 / torch.clamp(L, min=1e-20)
    out = merged[1] * Linv[..., None]
    if not with_pos:
        return out, M, L, None, None
    return out, M, L, merged[3] * Linv[..., None], merged[2] * Linv


class _GATFused(torch.autograd.Function):
    """Pass A forward; closed-form d_ar and pass B backward."""

    @staticmethod
    def forward(ctx, ar, ac, feat, adj_fwd, adj_bwd, slope, p, seed,
                dense_dtype, gid):
        out, M, L, out_pos, r = _gat_forward(adj_fwd, ar, ac, feat, slope,
                                             p, seed, dense_dtype, gid=gid)
        ctx.save_for_backward(ar, ac, feat, M, L, out, out_pos, r)
        ctx.adj_bwd, ctx.slope, ctx.p, ctx.seed = adj_bwd, slope, p, seed
        ctx.dense_dtype, ctx.gid = dense_dtype, gid
        return out

    @staticmethod
    def backward(ctx, g_out):
        ar, ac, feat, M, L, out, out_pos, r = ctx.saved_tensors
        slope, p, seed, gid = ctx.slope, ctx.p, ctx.seed, ctx.gid
        adj_bwd = ctx.adj_bwd
        dt = feat.dtype  # the gathered rows' type
        g = g_out.to(dt).contiguous()
        g32 = g.float()
        # per-destination softmax backward, closed-form (module docstring)
        ws = (g32 * out).sum(dim=-1)
        t1 = (g32 * (slope * out + (1.0 - slope) * out_pos)).sum(dim=-1)
        t2 = slope + (1.0 - slope) * r
        d_ar = t1 - ws * t2
        # pass B over the CSC bins: dX and d attn_col, per-source sums; the
        # destination columns in float32 (module docstring)
        Linv = 1.0 / torch.clamp(L, min=1e-20)
        cols = (ar, M, Linv, ws)
        tail = None
        if adj_bwd.dense is not None:
            # transposed block: rows = sources, cols = destinations; its
            # rows follow every bin's
            tail = dense_gat_bwd(adj_bwd.dense, g32, *cols, ac, feat.float(),
                                 slope=slope, p=p, seed=seed,
                                 dense_dtype=ctx.dense_dtype, gid=gid)
        dx, dac = bin_gat_bwd_list(g, *cols, ac, feat, adj_bwd.segs(),
                                   slope=slope, p=p, seed=seed, tail=tail,
                                   gid=gid)
        d_feat, d_ac = combine_sum(adj_bwd.cmb, [dx, dac])
        need = ctx.needs_input_grad
        return (d_ar if need[0] else None, d_ac if need[1] else None,
                d_feat.to(dt) if need[2] else None) + (None,) * 7


def gat_aggregate(graph: Graph, attn_row, attn_col, feat, *,
                  negative_slope: float = 0.2, attn_drop: float = 0.0,
                  seed=None, training: bool = False,
                  gather_dtype=None, dense_dtype: str = "bfloat16"):
    """Fused GAT neighbourhood aggregation.

    out[i, h] = sum_j softmax_j(LeakyReLU(attn_row[i,h] + attn_col[j,h]))
                * feat[j, h, :]        over in-neighbours j of i.

    Args:
      graph: Graph (graph.structure.build_graph) on the tensors' device.
      attn_row: [N, H] float32 destination attention coefficients.
      attn_col: [N, H] float32 source attention coefficients.
      feat: [N, H, F] float32 node features.
      negative_slope: LeakyReLU slope for edge scores.
      attn_drop: attention dropout probability (training only).
      seed: uint32 dropout seed, required if training and attn_drop > 0
        (the JAX package draws it as ``jax.random.bits(key, uint32)``): a
        Python int, or a one-element integer tensor on the op's device
        read as uint32 (int32 holds its bits), which no step reads back to
        the host.
      training: enables dropout.
      gather_dtype: None (float32) or ``torch.bfloat16`` (also
        "bfloat16"): the storage type of the gathered feature rows, rounded
        as the module docstring says; sums stay float32.
      dense_dtype: operand precision of the hub block's products:
        "bfloat16" (the default, as the JAX op) rounds them to bf16 and sums
        in float32; "float32" is exact.  Unused without a hub block.
    Returns:
      [N, H, F] float32 aggregated features.

    When no input needs a gradient (inference, or under ``torch.no_grad``),
    the forward skips the sign-split partials and saves nothing.
    """
    return gat_fused(graph.fwd, graph.bwd, attn_row, attn_col, feat,
                     negative_slope=negative_slope, attn_drop=attn_drop,
                     seed=seed, training=training, gather_dtype=gather_dtype,
                     dense_dtype=dense_dtype)


def gat_fused(adj_fwd: BinnedAdj, adj_bwd: BinnedAdj, attn_row, attn_col,
              feat, *, negative_slope: float = 0.2, attn_drop: float = 0.0,
              seed=None, training: bool = False,
              gather_dtype=None, dense_dtype: str = "bfloat16", gid=None):
    """``gat_aggregate`` over an adjacency pair whose destination and
    source spaces may differ.

    adj_fwd: rows = the Nd destinations, slots = sources; adj_bwd: its
    transpose, rows = the Ns sources.  attn_row: [Nd, H]; attn_col: [Ns,
    H]; feat: [Ns, H, F].  gid: None, or an int32 table that maps both
    spaces' ids to the ids the dropout hash takes (a graph shard's
    ext_gids, whose first Nd entries are its destination rows' global
    ids); it is handed to the kernels only when dropout is on.  Other
    arguments and the result ([Nd, H, F]) as ``gat_aggregate``.
    """
    rows = gather_type(gather_dtype)
    if dense_dtype not in DENSE_DTYPES:
        raise ValueError(f"dense_dtype must be one of {DENSE_DTYPES}, got "
                         f"{dense_dtype!r}")
    if adj_fwd.cmb is None or adj_bwd.cmb is None:
        raise ValueError("gat_aggregate needs the graph's combine tables")
    for name, t in (("attn_row", attn_row), ("attn_col", attn_col),
                    ("feat", feat)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    p = float(attn_drop) if training else 0.0
    if p > 0.0:
        if seed is None:
            raise ValueError("attn_drop > 0 requires a seed in training")
        check_seed(seed, feat.device)
    else:
        seed = 0
        gid = None  # the hash is not taken
    slope = float(negative_slope)
    ar, ac = attn_row.contiguous(), attn_col.contiguous()
    # the gathered rows' type; the cast's own gradient widens d_feat
    x = feat.to(rows).contiguous()
    if not (torch.is_grad_enabled()
            and (ar.requires_grad or ac.requires_grad or x.requires_grad)):
        return _gat_forward(adj_fwd, ar, ac, x, slope, p, seed,
                            dense_dtype, with_pos=False, gid=gid)[0]
    return _GATFused.apply(ar, ac, x, adj_fwd, adj_bwd, slope, p, seed,
                           dense_dtype, gid)
