"""GMMConv (MoNet) layer and network as ``nn.Module``s (port of
``dgnn_tpu/models/monet.py``).

The dense projection ``fc`` is plain torch (``nn.Linear``); everything
sparse, and the per-layer pseudo-coordinate projection Linear(Ds + Dd, dim)
+ tanh, runs inside the fused ``gmm_aggregate_node`` op.  Semantics match
the flax modules: the K kernels' outputs are summed, an optional residual
connection (projected by ``res_fc`` when the widths differ) and bias follow,
and the network applies feature dropout before every layer but the first.

Init follows the flax initialisers: ``fc`` and ``res_fc`` xavier-normal with
the ReLU gain (``variance_scaling(2, "fan_avg", "normal")``), ``mu``
N(0, 0.1), ``inv_sigma`` ones, ``pseudo_w`` lecun-normal (a normal truncated
at two standard deviations with variance 1 / fan_in), biases zero.  Every
random draw (init, feature dropout) comes from an explicit
``torch.Generator``.

This port takes node-derived pseudo-coordinates (``ops.gmm.NodePseudo``)
only; flat ``[E, D]`` pseudo, pre-binned pseudo tables and the bf16
``gather_dtype`` of the flax modules are ROADMAP A6's remainder.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..graph.structure import Graph
from ..ops.gmm import NodePseudo, gmm_aggregate_node
from .gat import _dropout, _fan_avg_normal_

__all__ = ["GMMConv", "MoNet"]

# std of a unit normal truncated at +-2, which flax's lecun_normal divides out
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator | None):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def _need_node_pseudo(pseudo):
    if not isinstance(pseudo, NodePseudo):
        raise NotImplementedError(
            "dgnn_tpu_torch's GMMConv takes a NodePseudo only; flat [E, D] "
            "pseudo-coordinates and pre-binned pseudo tables are not ported "
            "yet (ROADMAP A6)")


class GMMConv(nn.Module):
    """Gaussian-mixture model convolution over the fused aggregation.

    Output: [N, out_feats].  ``pseudo_in`` is Ds + Dd, the number of raw
    pseudo scalars per edge (flax infers it at init from the pseudo)."""

    def __init__(self, in_feats: int, out_feats: int, dim: int,
                 n_kernels: int, *, pseudo_in: int = 2,
                 residual: bool = False, use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.out_feats = out_feats
        self.n_kernels = n_kernels
        kf = n_kernels * out_feats
        self.fc = nn.Linear(in_feats, kf, bias=False)
        _fan_avg_normal_(self.fc.weight, in_feats, kf, generator)
        self.mu = nn.Parameter(torch.empty(n_kernels, dim))
        with torch.no_grad():
            self.mu.normal_(0.0, 0.1, generator=generator)
        self.inv_sigma = nn.Parameter(torch.ones(n_kernels, dim))
        self.pseudo_w = nn.Parameter(torch.empty(pseudo_in, dim))
        _lecun_normal_(self.pseudo_w, pseudo_in, generator)
        self.pseudo_b = nn.Parameter(torch.zeros(dim))
        self.residual = residual
        self.res_fc = None
        if residual and in_feats != out_feats:
            self.res_fc = nn.Linear(in_feats, out_feats, bias=False)
            _fan_avg_normal_(self.res_fc.weight, in_feats, out_feats,
                             generator)
        self.bias = nn.Parameter(torch.zeros(out_feats)) if use_bias else None

    def forward(self, graph: Graph, feat: torch.Tensor,
                pseudo: NodePseudo) -> torch.Tensor:
        _need_node_pseudo(pseudo)
        x = self.fc(feat).reshape(-1, self.n_kernels, self.out_feats)
        rst = gmm_aggregate_node(graph, x, pseudo.src, pseudo.dst, self.mu,
                                 self.inv_sigma, proj_weight=self.pseudo_w,
                                 proj_bias=self.pseudo_b, use_tanh=True)
        rst = rst.sum(dim=1)  # sum over the kernels
        if self.residual:
            rst = rst + (feat if self.res_fc is None else self.res_fc(feat))
        if self.bias is not None:
            rst = rst + self.bias
        return rst


class MoNet(nn.Module):
    """MoNet stack: ``n_layers`` hidden GMMConv layers and an output layer,
    each with its own pseudo projection, feature dropout between them.
    Layers are ``convs["gmm_0"] ... convs["gmm_<n_layers>"]``, the flax
    module names."""

    def __init__(self, in_feats: int, n_hidden: int, out_feats: int,
                 n_layers: int, dim: int, n_kernels: int, *,
                 dropout: float = 0.5, pseudo_in: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dropout = dropout
        convs = {}
        width = in_feats
        for i, out in enumerate([n_hidden] * n_layers + [out_feats]):
            convs[f"gmm_{i}"] = GMMConv(width, out, dim, n_kernels,
                                        pseudo_in=pseudo_in,
                                        generator=generator)
            width = out
        self.convs = nn.ModuleDict(convs)

    def forward(self, graph: Graph, feat: torch.Tensor, pseudo: NodePseudo, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits [N, out_feats].  In training, ``generator`` draws the
        feature dropout."""
        _need_node_pseudo(pseudo)
        h = feat
        for i, conv in enumerate(self.convs.values()):
            if i != 0 and self.training and self.dropout > 0.0:
                h = _dropout(h, self.dropout, generator)
            h = conv(graph, h, pseudo)
        return h
