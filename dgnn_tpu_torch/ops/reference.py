"""Dense oracles (port of ``dgnn_tpu/ops/reference.py``).

Straightforward dense implementations of the three aggregations, the
ground truth that the port's tests hold the fused ops against without
JAX.  They materialise a dense [N, N] adjacency, so tests keep N small.
``dense_adj`` and ``dense_edge_ids`` are numpy; the aggregations take
torch tensors (an adjacency or edge-id table may be numpy or torch) and
are differentiable by autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import leaky_relu, pair_keep

__all__ = ["dense_adj", "dense_edge_ids", "gat_dense", "gmm_dense",
           "edgeconv_dense"]


def dense_adj(row_ptr, col_ind, num_nodes: int) -> np.ndarray:
    """bool [N, N]: adj[i, j] = edge j -> i exists (i aggregates j)."""
    row_ptr = np.asarray(row_ptr)
    col_ind = np.asarray(col_ind)
    adj = np.zeros((num_nodes, num_nodes), dtype=bool)
    rows = np.repeat(np.arange(num_nodes), np.diff(row_ptr))
    adj[rows, col_ind] = True
    return adj


def dense_edge_ids(row_ptr, col_ind, num_nodes: int) -> np.ndarray:
    """int64 [N, N]: CSR edge id at (dst, src), -1 where no edge (the last
    copy of a duplicate edge wins)."""
    row_ptr = np.asarray(row_ptr)
    col_ind = np.asarray(col_ind)
    eid = np.full((num_nodes, num_nodes), -1, dtype=np.int64)
    rows = np.repeat(np.arange(num_nodes), np.diff(row_ptr))
    eid[rows, col_ind] = np.arange(col_ind.shape[0])
    return eid


def gat_dense(adj, attn_row, attn_col, feat, negative_slope=0.2,
              attn_drop=0.0, seed=None, dst_ids=None, src_ids=None):
    """Dense multi-head GAT aggregation.

    adj: [N, N] bool (dst, src).  attn_row / attn_col: [N, H].  feat:
    [N, H, F].  With ``attn_drop`` > 0 the attention is dropped by
    ``pair_keep(seed, dst, src)``, the fused op's hash; ``dst_ids`` /
    ``src_ids`` override the node ids it hashes (default: 0..N-1).
    Returns (out [N, H, F], edge_max [N, H] (-inf on an empty row),
    edge_sum [N, H]).
    """
    adj = torch.as_tensor(adj, device=feat.device)
    s = leaky_relu(attn_row[:, None, :] + attn_col[None, :, :],
                   negative_slope)
    s = torch.where(adj[..., None], s, float("-inf"))  # [N, N, H]
    m = s.amax(dim=1)  # [N, H]
    msafe = torch.where(torch.isneginf(m), 0.0, m)
    w = torch.where(adj[..., None], torch.exp(s - msafe[:, None, :]), 0.0)
    l = w.sum(dim=1)  # [N, H]
    a = w / torch.clamp(l, min=1e-20)[:, None, :]
    if attn_drop > 0.0:
        nd, ns = adj.shape
        d = (torch.arange(nd, device=feat.device) if dst_ids is None
             else torch.as_tensor(dst_ids, device=feat.device))
        sidx = (torch.arange(ns, device=feat.device) if src_ids is None
                else torch.as_tensor(src_ids, device=feat.device))
        keep = pair_keep(seed, d[:, None], sidx[None, :], attn_row.shape[1],
                         attn_drop)
        a = a * torch.where(adj[..., None], keep, 0.0)
    out = torch.einsum("dsh,shf->dhf", a, feat)
    return out, m, l


def gmm_dense(adj_edge_ids, feat, pseudo, mu, inv_sigma):
    """Dense MoNet aggregation.  adj_edge_ids: [N, N] int (-1 = no edge),
    feat: [N, K, F], pseudo: [E, D], mu / inv_sigma: [K, D].
    out[n, k, f] = sum_{j: e = (j -> n)} w[e, k] * feat[j, k, f]."""
    eid = torch.as_tensor(adj_edge_ids, device=feat.device).long()
    has = eid >= 0
    ps = pseudo[eid.clamp(min=0)]  # [N, N, D]
    t = (ps[:, :, None, :] - mu) * inv_sigma  # [N, N, K, D]
    w = torch.exp(-0.5 * (t * t).sum(dim=-1))  # [N, N, K]
    w = torch.where(has[..., None], w, 0.0)
    return torch.einsum("dsk,skf->dkf", w, feat)


def edgeconv_dense(nbr, h_src, h_dst):
    """nbr: [N, k] neighbour ids; out[i, f] = max_j (h_dst[i, f] +
    h_src[nbr[i, j], f])."""
    nbr = torch.as_tensor(nbr, device=h_src.device).long()
    return (h_dst[:, None, :] + h_src[nbr]).amax(dim=1)
