"""Plain MoNet (Monti et al., 2017) with GMMConv layers as the port's
``models.MoNet`` states it (node pseudo-coordinates), over the
benchmark's CSR in blocks of edges.

Each edge u -> v has the pseudo-coordinates (deg(u)^-1/2, deg(v)^-1/2),
in-degrees with the self loop, at least 1; a layer projects them,
p = tanh(pseudo W_p + b_p) (dim D), weighs the edge per kernel k by
w_k = exp(-1/2 sum_d ((p_d - mu_kd) inv_sigma_kd)^2), and sums
out[v] = sum_k sum_u w_k x[u, k] with x = h fc^T as [N, K, F], then adds
its bias.  Feature dropout acts on each layer's input but the first; no
activation between layers, as the port's model (and DGL's MoNet example)
builds them.  The sum aggregator is DGL GMMConv's default.

Each block of edges runs under activation checkpointing, as in gat.py.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from gnnbench.reference.common import (Edges, dropout, precision, rounder,
                                       train_steps)

__all__ = ["layers", "forward", "train", "infer"]


def layers(cfg: dict, n_classes: int) -> list:
    """(name, width) of each layer."""
    return ([(f"gmm_{i}", cfg["n_hidden"]) for i in range(cfg["n_layers"])]
            + [(f"gmm_{cfg['n_layers']}", n_classes)])


def _block(x, rsq, pw, pb, mu, isig, d, s, q):
    n, k, f = x.shape
    u = torch.stack([rsq[s], rsq[d]], dim=1)
    p = torch.tanh(u @ pw + pb)
    t = (p[:, None, :] - mu) * isig
    wk = q(torch.exp(-0.5 * (t * t).sum(-1)))
    return x.new_zeros(n, k, f).index_add(0, d, wk[..., None] * x[s])


def aggregate(x, rsq, pw, pb, mu, isig, edges: Edges, q):
    """The Gaussian-weighted sum over each node's in-edges: [N, K, F]."""
    xq = q(x)
    out = 0.0
    for d, s in edges.blocks():
        args = (xq, rsq, pw, pb, mu, isig, d, s, q)
        if torch.is_grad_enabled():
            out = out + checkpoint(_block, *args, use_reentrant=False)
        else:
            out = out + _block(*args)
    return out


def forward(cfg: dict, w: dict, feats, edges: Edges, n_classes: int, *,
            generator=None, q=None):
    """Logits [N, C]; feature dropout where ``generator`` is given."""
    q = q or rounder(None)
    rsq = torch.rsqrt(edges.in_degree.float().clamp(min=1.0))
    n, k = feats.shape[0], cfg["n_kernels"]
    h = feats
    for i, (name, width) in enumerate(layers(cfg, n_classes)):
        if i > 0 and generator is not None and cfg["dropout"] > 0:
            h = dropout(h, cfg["dropout"], generator)
        x = (h @ w[f"{name}.fc"].T).reshape(n, k, width)
        o = aggregate(x, rsq, w[f"{name}.pseudo_w"], w[f"{name}.pseudo_b"],
                      w[f"{name}.mu"], w[f"{name}.inv_sigma"], edges, q)
        h = o.sum(1) + w[f"{name}.bias"]
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
