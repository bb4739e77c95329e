"""Fused MoNet/GMMConv aggregation with node-derived pseudo-coordinates.

Port of the node-pseudo path of ``dgnn_tpu/ops/gmm.py``
(``gmm_aggregate_node``, ``_node_fwd``, ``_node_bwd`` and their custom VJP)
as a ``torch.autograd.Function``.  Per edge e = (u -> v) with K Gaussian
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

The per-bin passes are ops/bins.bin_gmm_node_fwd / bin_gmm_node_bwd, and a
graph's tile-sparse hub block (graph.structure.DenseBlock) runs through
ops/dense.dense_gmm_fwd / dense_gmm_bwd, whose per-row partials are appended
after the bins'.  Each is a CUDA kernel for CUDA tensors and its plain
version for CPU tensors.  The backward saves only its inputs and recomputes
alpha, beta and the edge weights.

Not ported yet (they reach no hand-written kernel): ``gmm_aggregate_binned``
(pre-binned per-edge pseudo tables) and the flat ``gmm_aggregate``.
"""

from __future__ import annotations

import typing

import torch

from ..graph.structure import BinnedAdj, Graph
from .bins import bin_gmm_node_bwd, bin_gmm_node_fwd
from .common import combine_sum, gaussian_terms
from .dense import DENSE_DTYPES, dense_gmm_bwd, dense_gmm_fwd

__all__ = ["NodePseudo", "gaussian_weights", "gmm_aggregate_node"]


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
    combine table: out[v] = sum_u w(alpha[u], beta[v]) * feat[u]."""
    accs = [bin_gmm_node_fwd(feat, alpha, beta, nbr, row, count, mu, isig,
                             use_tanh=use_tanh)
            for _width, nbr, _edge, row, count in adj.bins()]
    if adj.dense is not None:
        accs.append(dense_gmm_fwd(adj.dense, beta, alpha, feat, mu, isig,
                                  use_tanh=use_tanh, dense_dtype=dense_dtype))
    return combine_sum(adj.cmb, torch.cat(accs))


def _node_backward(adj_bwd: BinnedAdj, alpha, beta, sfeat, dfeat, feat, mu,
                   isig, use_tanh, dense_dtype, g):
    """Single CSC pass: dX per source, and the parameter gradients as sums
    of the kernels' stat rows (layout: bins.bin_gmm_node_bwd).  Returns
    (d_feat, d_mu, d_isig, d_pbias, d_pw_s, d_pw_d)."""
    K, D = mu.shape
    KD = K * D
    Dd, Ds = dfeat.shape[1], sfeat.shape[1]
    cut = 2 * KD + D + D * Dd  # where the bins' sfeat block starts
    dxs, sts = [], []
    for _width, nbr, _edge, row, count in adj_bwd.bins():
        dx_p, st = bin_gmm_node_bwd(g, beta, dfeat, alpha, feat, sfeat, nbr,
                                    row, count, mu, isig, use_tanh=use_tanh)
        dxs.append(dx_p)
        sts.append(st)
    tot = torch.cat(sts).sum(dim=0)
    st_sum, d_pws = tot[:cut], tot[cut:].reshape(D, Ds).T
    if adj_bwd.dense is not None:
        db = adj_bwd.dense
        dx_p, st = dense_gmm_bwd(db, g, beta, dfeat, alpha, feat, mu, isig,
                                 use_tanh=use_tanh, dense_dtype=dense_dtype)
        dxs.append(dx_p)
        # padded block rows carry no edge; their stats are zeroed all the same
        valid = torch.arange(db.row_ids.shape[0],
                             device=g.device) < db.num_rows
        st = torch.where(valid[:, None], st, 0.0)
        st_sum = st_sum + st.sum(dim=0)
        # the block's stat row has no sfeat block: the rows' sum of dpre
        # times their own raw source scalars
        rs = st[:, 2 * KD:2 * KD + D]
        d_pws = d_pws + sfeat[db.row_ids.long()].T @ rs
    d_feat = combine_sum(adj_bwd.cmb, torch.cat(dxs))
    d_mu = st_sum[:KD].reshape(K, D) * isig
    d_isig = -st_sum[KD:2 * KD].reshape(K, D)
    d_pb = st_sum[2 * KD:2 * KD + D]
    d_pwd = st_sum[2 * KD + D:].reshape(D, Dd).T
    return d_feat, d_mu, d_isig, d_pb, d_pws, d_pwd


class _GMMNode(torch.autograd.Function):
    """CSR pass forward; one CSC pass backward.  src/dst scalars take no
    gradient."""

    @staticmethod
    def forward(ctx, sfeat, dfeat, feat, pw_s, pw_d, pbias, mu, isig, graph,
                use_tanh, dense_dtype):
        alpha, beta = _project(sfeat, dfeat, pw_s, pw_d, pbias)
        out = _node_forward(graph.fwd, alpha, beta, feat, mu, isig, use_tanh,
                            dense_dtype)
        ctx.save_for_backward(sfeat, dfeat, feat, pw_s, pw_d, pbias, mu, isig)
        ctx.graph, ctx.use_tanh, ctx.dense_dtype = graph, use_tanh, dense_dtype
        return out

    @staticmethod
    def backward(ctx, g_out):
        sfeat, dfeat, feat, pw_s, pw_d, pbias, mu, isig = ctx.saved_tensors
        alpha, beta = _project(sfeat, dfeat, pw_s, pw_d, pbias)
        d_feat, d_mu, d_isig, d_pb, d_pws, d_pwd = _node_backward(
            ctx.graph.bwd, alpha, beta, sfeat.float().contiguous(),
            dfeat.float().contiguous(), feat, mu, isig, ctx.use_tanh,
            ctx.dense_dtype, g_out.float().contiguous())
        need = ctx.needs_input_grad
        grads = (None, None, d_feat, d_pws, d_pwd, d_pb, d_mu, d_isig)
        return tuple(g if n else None for g, n in zip(grads, need)) + (
            None, None, None)


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
      gather_dtype: bf16 feature gathers are not ported yet; must be None.
    Returns:
      [N, K, F] float32 (the caller sums over K).

    When no input needs a gradient (inference, or under ``torch.no_grad``),
    the forward saves nothing.
    """
    if gather_dtype is not None:
        raise NotImplementedError("gather_dtype (bf16 feature gathers) is not "
                                  "ported to dgnn_tpu_torch yet")
    if dense_dtype not in DENSE_DTYPES:
        raise ValueError(f"dense_dtype must be one of {DENSE_DTYPES}, got "
                         f"{dense_dtype!r}")
    if graph.fwd.cmb is None or graph.bwd.cmb is None:
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
    x, mu, isig = feat.contiguous(), mu.contiguous(), inv_sigma.contiguous()
    diff = (x, pw_s, pw_d, proj_bias, mu, isig)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in diff)):
        alpha, beta = _project(src_scalars, dst_scalars, pw_s, pw_d,
                               proj_bias)
        return _node_forward(graph.fwd, alpha, beta, x, mu, isig,
                             bool(use_tanh), dense_dtype)
    return _GMMNode.apply(src_scalars, dst_scalars, x, pw_s, pw_d, proj_bias,
                          mu, isig, graph, bool(use_tanh), dense_dtype)
