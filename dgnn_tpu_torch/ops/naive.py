"""Naive (materialising) baselines: what DGL / PyG-style frameworks do
(port of ``dgnn_tpu/ops/naive.py``).

dgNN's headline compares its fused kernels against DGL's execution
strategy: per-edge score, softmax and message tensors ([E, H] and
[E, H, F]) materialised in device memory and reduced with segment ops.
These are that baseline, in plain torch on every device (the JAX package
runs them as XLA segment ops, no Pallas kernel), against which the fused
binned path shows its time and memory.  They read the raw CSR
(``graph.row_ptr`` / ``graph.col_ind``), so a slim graph is refused, and
every CSR edge counts, duplicates included (a hub block counts a
duplicate edge once: on a multigraph built with a block the two differ).
"""

from __future__ import annotations

import torch

from ..graph.structure import Graph
from .common import leaky_relu, pair_keep
from .gmm import gaussian_weights
from .primitives import edge_rows, segment_max, segment_sum

__all__ = ["gat_naive", "gmm_naive"]


def gat_naive(graph: Graph, attn_row, attn_col, feat, *,
              negative_slope: float = 0.2, attn_drop: float = 0.0,
              seed=None, training: bool = False):
    """Edge-materialising GAT aggregation (DGL edge_softmax + update_all).

    Same arguments and result as ``ops.gat.gat_aggregate`` (without its
    layout options): attention dropout in training drops the pairs
    ``pair_keep(seed, dst, src)`` drops, as the fused op does, so the same
    seed drops the same pairs in both; the seed is an int or a one-element
    integer tensor on the op's device, as the fused op takes it, so a step
    through this baseline can be captured too.  Autograd saves the [E, H, F]
    message tensor, the memory the fused op does not spend (dgNN's 8.3 GB
    against DGL's 22.5 GB on Reddit, SURVEY.md §2.2)."""
    row = edge_rows(graph)
    col = graph.col_ind.long()
    n = graph.num_nodes
    s = leaky_relu(attn_row[row] + attn_col[col], negative_slope)  # [E, H]
    m = segment_max(s, row, n)
    # an empty row's max is -inf: take 0, as the JAX baseline does
    m = torch.where(torch.isneginf(m), 0.0, m)
    w = torch.exp(s - m[row])
    l = segment_sum(w, row, n)
    a = w / torch.clamp(l, min=1e-20)[row]
    if training and attn_drop > 0.0:
        if seed is None:
            raise ValueError("attn_drop > 0 requires a seed in training")
        a = a * pair_keep(seed, row, col, attn_row.shape[1], attn_drop)
    msg = a[..., None] * feat[col]  # [E, H, F] materialised
    return segment_sum(msg, row, n)


def gmm_naive(graph: Graph, feat, pseudo, mu, inv_sigma):
    """Edge-materialising MoNet aggregation: feat [N, K, F], pseudo [E, D]
    in CSR edge order, mu / inv_sigma [K, D] -> [N, K, F]."""
    row = edge_rows(graph)
    w = gaussian_weights(pseudo, mu, inv_sigma)  # [E, K]
    msg = w[..., None] * feat[graph.col_ind.long()]  # [E, K, F]
    return segment_sum(msg, row, graph.num_nodes)
