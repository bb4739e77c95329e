"""EdgeConv layer and DGCNN point-cloud classifier as ``nn.Module``s (port
of ``dgnn_tpu/models/dgcnn.py``).

The k-NN graph is rebuilt from the current features before every EdgeConv,
on the device and under ``no_grad`` (graph/knn.py), as a dense per-cloud
mask; layer outputs are concatenated, projected, max- and mean-pooled, then
an MLP head.  The dense projections are ``nn.Linear``; the masked
neighbour max of every layer is the hand-written kernel behind
``ops.edgeconv.edge_conv_max_dense``.

Init follows the flax defaults: lecun-normal kernels, zero biases, batch
norm scale 1 and bias 0.  ``BatchNorm`` is flax's, not torch's: momentum
0.99 on the running statistics (torch would say 0.01), eps 1e-5, and the
running variance is the BIASED batch variance, computed as
max(0, E[x^2] - E[x]^2) over every axis but the last.  Every random draw
(init, dropout) comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.knn import knn_mask_neg
from ..ops.edgeconv import edge_conv_max, edge_conv_max_dense
from .gat import _dropout
from .monet import _lecun_normal_

__all__ = ["BatchNorm", "EdgeConv", "DGCNN"]


def _dense(in_feats: int, out_feats: int, bias: bool,
           generator: torch.Generator | None) -> nn.Linear:
    lin = nn.Linear(in_feats, out_feats, bias=bias)
    _lecun_normal_(lin.weight, in_feats, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm over the last axis (module docstring).
    Parameters ``scale`` and ``bias``, buffers ``mean`` and ``var``, the
    flax names."""

    def __init__(self, num_features: int, *, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def batch_stats(self, x: torch.Tensor):
        """The mean and biased variance of ``x`` over every axis but the
        last, in training."""
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes)
        return mean, ((x * x).mean(dim=axes) - mean * mean).clamp(min=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = self.batch_stats(x)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(
                    mean, alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(
                    var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


class EdgeConv(nn.Module):
    """theta/phi formulation: out[i] = max_j (phi(x_i) + theta(x_j - x_i)),
    computed as max_j (h_dst[i] + h_src[j]) with h_src = theta(x) and
    h_dst = phi(x) - theta(x).

    ``adj`` is either an explicit [N, k] neighbour-id table with [N, C]
    features (the gather path) or a dense [B, P, P] additive mask with
    [B, P, C] features (the path the model takes)."""

    def __init__(self, in_feats: int, out_feats: int, *,
                 batch_norm: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.theta = _dense(in_feats, out_feats, False, generator)
        self.phi = _dense(in_feats, out_feats, False, generator)
        self.bn = BatchNorm(out_feats) if batch_norm else None

    def forward(self, adj: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        h_theta = self.theta(feat)
        h_phi = self.phi(feat)
        if adj.dim() == 3:
            out = edge_conv_max_dense(adj, h_theta, h_phi - h_theta)
        else:
            out = edge_conv_max(adj, h_theta, h_phi - h_theta)
        if self.bn is not None:
            out = self.bn(out)
        return out


class DGCNN(nn.Module):
    """Dynamic graph CNN for point-cloud classification.  Layers are
    ``convs["conv_<i>"]``, ``proj``, ``embs["emb_<i>"]`` with
    ``bns["bn_<i>"]`` (i from 1) and ``head``, the flax module names."""

    def __init__(self, k: int = 40,
                 feature_dims: Sequence[int] = (64, 64, 128, 256),
                 emb_dims: Sequence[int] = (512, 512, 256),
                 output_classes: int = 40, dropout: float = 0.5, *,
                 in_feats: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.k = k
        self.dropout = dropout
        convs = {}
        width = in_feats
        for i, dim in enumerate(feature_dims):
            convs[f"conv_{i}"] = EdgeConv(width, dim, generator=generator)
            width = dim
        self.convs = nn.ModuleDict(convs)
        self.proj = _dense(sum(feature_dims), emb_dims[0], True, generator)
        embs, bns = {}, {}
        width = 2 * emb_dims[0]
        for i in range(1, len(emb_dims)):
            embs[f"emb_{i}"] = _dense(width, emb_dims[i], True, generator)
            bns[f"bn_{i}"] = BatchNorm(emb_dims[i])
            width = emb_dims[i]
        self.embs = nn.ModuleDict(embs)
        self.bns = nn.ModuleDict(bns)
        self.head = _dense(width, output_classes, True, generator)

    def forward(self, x: torch.Tensor, *,
                generator: torch.Generator | None = None,
                masks: Sequence[torch.Tensor] | None = None,
                masks_out: list | None = None) -> torch.Tensor:
        """Logits [B, classes] of clouds x [B, P, C].  In training,
        ``generator`` draws the dropout.  ``masks`` hands in one [B, P, P]
        mask per EdgeConv layer instead of building it from the features;
        ``masks_out`` collects the masks the layers used."""
        hs = []
        h = x
        for i, conv in enumerate(self.convs.values()):
            if masks is not None:
                mask = masks[i]
            else:
                # dynamic graph from the current features; never
                # differentiated
                with torch.no_grad():
                    mask = knn_mask_neg(h, self.k)
            if masks_out is not None:
                masks_out.append(mask)
            h = F.leaky_relu(conv(mask, h), negative_slope=0.2)
            hs.append(h)
        h = self.proj(torch.cat(hs, dim=-1))
        h = torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)
        for emb, bn in zip(self.embs.values(), self.bns.values()):
            h = F.leaky_relu(bn(emb(h)), negative_slope=0.2)
            if self.training and self.dropout > 0.0:
                h = self.feature_dropout(h, generator)
        return self.head(h)

    def feature_dropout(self, h: torch.Tensor,
                        generator: torch.Generator | None) -> torch.Tensor:
        """The head's dropout of the clouds' features h [B, C]."""
        return _dropout(h, self.dropout, generator)
