"""Plain GAT (Velickovic et al., 2018) as the port's ``models.GAT`` states
it, over the benchmark's CSR in blocks of edges.

A layer: x = h W^T as [N, H, F]; feature dropout on x in training;
a_dst = <attn_l, x>, a_src = <attn_r, x> per head; for each edge u -> v
the score LeakyReLU(a_dst[v] + a_src[u]), a softmax over v's in-edges,
out[v] = sum of the softmax times x[u]; the output layer adds its bias
and averages its heads.  Hidden layers have no bias on the first layer,
no activation and no residual, as the port's model (and the flax model
it mirrors) builds them.  Departure from DGL's GATConv: the dropout acts
on the projected features, not on the layer's input.

Each block of edges runs under activation checkpointing, so a step at
Reddit's size holds a block's per-edge tensors, never all of them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gnnbench.reference.common import (Edges, dropout, precision, rounder,
                                       train_steps)

__all__ = ["layers", "forward", "train", "infer"]


def layers(cfg: dict, n_classes: int) -> list:
    """(name, heads, width) of each layer."""
    hidden = [(f"gat_{i}", cfg["heads"][i], cfg["n_hidden"])
              for i in range(cfg["num_layers"])]
    return hidden + [("gat_out", cfg["heads"][-1], n_classes)]


def _block(x, a_dst, a_src, m, d, s, slope, q):
    n, h, f = x.shape
    p = q(torch.exp(F.leaky_relu(a_dst[d] + a_src[s], slope) - m[d]))
    den = x.new_zeros(n, h).index_add(0, d, p)
    num = x.new_zeros(n, h, f).index_add(0, d, p[..., None] * x[s])
    return den, num


def aggregate(x, a_dst, a_src, edges: Edges, slope: float, q):
    """Softmax-weighted sum over each node's in-edges: [N, H, F]."""
    n, h, _ = x.shape
    with torch.no_grad():  # the softmax's shift: any bound gives the same
        m = torch.full((n, h), float("-inf"), device=x.device)
        for d, s in edges.blocks():
            sc = F.leaky_relu(a_dst[d] + a_src[s], slope)
            m.scatter_reduce_(0, d[:, None].expand(-1, h), sc, "amax")
    xq = q(x)
    den = num = 0.0
    for d, s in edges.blocks():
        if torch.is_grad_enabled():
            b = checkpoint(_block, xq, a_dst, a_src, m, d, s, slope, q,
                           use_reentrant=False)
        else:
            b = _block(xq, a_dst, a_src, m, d, s, slope, q)
        den, num = den + b[0], num + b[1]
    return num / den[..., None]


def forward(cfg: dict, w: dict, feats, edges: Edges, n_classes: int, *,
            generator=None, q=None):
    """Logits [N, C]; feature dropout where ``generator`` is given."""
    q = q or rounder(None)
    h = feats
    n = feats.shape[0]
    for name, heads, width in layers(cfg, n_classes):
        x = (h @ w[f"{name}.W"].T).reshape(n, heads, width)
        if generator is not None and cfg["feat_drop"] > 0:
            x = dropout(x, cfg["feat_drop"], generator)
        a_dst = (w[f"{name}.attn_l"] * x).sum(-1)
        a_src = (w[f"{name}.attn_r"] * x).sum(-1)
        o = aggregate(x, a_dst, a_src, edges, cfg["negative_slope"], q)
        if f"{name}.bias" in w:
            o = o + w[f"{name}.bias"]
        h = o.mean(1) if name == "gat_out" else o.reshape(n, -1)
    return h


def train(cfg: dict, weights: dict, feats, labels, edges: Edges,
          n_classes: int, steps: int, drop_seed: int, *, lowp=None,
          rows=None, fault=None) -> dict:
    """``steps`` training steps (common.train_steps) from ``weights``."""
    def fwd(params, gen, q):
        return forward(cfg, params, feats, edges, n_classes, generator=gen,
                       q=q)

    return train_steps(fwd, weights, labels, steps, drop_seed, cfg["lr"],
                       cfg["weight_decay"], lowp=lowp, rows=rows,
                       fault=fault)


def infer(cfg: dict, weights: dict, feats, edges: Edges, n_classes: int, *,
          lowp=None, rows=None):
    """The logits of one forward with no dropout and no gradient; the
    per-edge operands stored as ``rows``, or as ``lowp`` (the control)."""
    with torch.no_grad(), precision(lowp):
        return forward(cfg, weights, feats, edges, n_classes,
                       q=rounder(lowp or rows))
