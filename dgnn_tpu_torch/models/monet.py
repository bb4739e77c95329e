"""GMMConv (MoNet) layer and network as ``nn.Module``s (port of
``dgnn_tpu/models/monet.py``).

The dense projection ``fc`` is plain torch (``nn.Linear``); everything
sparse runs inside the fused ops of ``ops/gmm.py``, one for each form of the
pseudo-coordinates, as the flax modules dispatch:

- ``NodePseudo`` (per-node scalars): ``gmm_aggregate_node``, with the
  per-layer projection Linear(Ds + Dd, dim) + tanh (``pseudo_w``,
  ``pseudo_b``) inside the op;
- a tuple of pre-binned raw tables (``ops.gmm.bin_pseudo``):
  ``gmm_aggregate_binned``, with the same projection inside the op
  (``pseudo_proj=True``) or the identity;
- a flat ``[E, D]`` tensor: ``gmm_aggregate``; ``MoNet`` projects the raw
  pseudo first with a Linear + tanh of its own a layer
  (``pseudo_projs["pseudo_proj_<i>"]``, the flax ``pseudo_proj_<i>``).  Semantics match
the flax modules: the K kernels' outputs are summed, an optional residual
connection (projected by ``res_fc`` when the widths differ) and bias follow,
and the network applies feature dropout before every layer but the first.

Init follows the flax initialisers: ``fc`` and ``res_fc`` xavier-normal with
the ReLU gain (``variance_scaling(2, "fan_avg", "normal")``), ``mu``
N(0, 0.1), ``inv_sigma`` ones, ``pseudo_w`` lecun-normal (a normal truncated
at two standard deviations with variance 1 / fan_in), biases zero.  Every
random draw (init, feature dropout) comes from an explicit
``torch.Generator``.

``gather_dtype`` ("bfloat16" halves the gathered feature rows) applies to
the node-pseudo op only, as in the flax modules.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..graph.structure import Graph
from ..ops.gmm import (NodePseudo, gmm_aggregate, gmm_aggregate_binned,
                       gmm_aggregate_node)
from .gat import _dropout, _fan_avg_normal_

__all__ = ["GMMConv", "MoNet", "PSEUDO_MODES"]

# std of a unit normal truncated at +-2, which flax's lecun_normal divides out
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator | None):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


# MoNet's pseudo-coordinate modes, by the form of the pseudo it takes
PSEUDO_MODES = ("node", "binned", "flat")


def _mode_of(pseudo) -> str:
    """The mode a pseudo argument selects, as the flax MoNet tells them
    apart: a NodePseudo, a tuple of binned tables, else a flat tensor."""
    if isinstance(pseudo, NodePseudo):
        return "node"
    return "binned" if isinstance(pseudo, tuple) else "flat"


class GMMConv(nn.Module):
    """Gaussian-mixture model convolution over the fused aggregation.

    Output: [N, out_feats].  ``pseudo_in`` is the number of raw pseudo
    scalars per edge (Ds + Dd for a NodePseudo; flax infers it at init from
    the pseudo).  ``pseudo_proj``: the layer holds the projection
    ``pseudo_w`` / ``pseudo_b`` that the node and binned ops apply inside;
    a node pseudo needs it, a binned one without it is taken as projected
    already (the identity), and a flat pseudo takes none."""

    def __init__(self, in_feats: int, out_feats: int, dim: int,
                 n_kernels: int, *, pseudo_in: int = 2,
                 pseudo_proj: bool = True, residual: bool = False,
                 use_bias: bool = True, gather_dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.out_feats = out_feats
        self.n_kernels = n_kernels
        self.gather_dtype = gather_dtype
        kf = n_kernels * out_feats
        self.fc = nn.Linear(in_feats, kf, bias=False)
        _fan_avg_normal_(self.fc.weight, in_feats, kf, generator)
        self.mu = nn.Parameter(torch.empty(n_kernels, dim))
        with torch.no_grad():
            self.mu.normal_(0.0, 0.1, generator=generator)
        self.inv_sigma = nn.Parameter(torch.ones(n_kernels, dim))
        self.pseudo_w = self.pseudo_b = None
        if pseudo_proj:
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
                pseudo) -> torch.Tensor:
        x = self.fc(feat).reshape(-1, self.n_kernels, self.out_feats)
        mode = _mode_of(pseudo)
        if mode == "node":
            if self.pseudo_w is None:
                raise ValueError("a NodePseudo needs the layer's pseudo "
                                 "projection (pseudo_proj=True)")
            rst = gmm_aggregate_node(graph, x, pseudo.src, pseudo.dst,
                                     self.mu, self.inv_sigma,
                                     proj_weight=self.pseudo_w,
                                     proj_bias=self.pseudo_b, use_tanh=True,
                                     gather_dtype=self.gather_dtype)
        elif mode == "binned":
            rst = gmm_aggregate_binned(graph, x, pseudo, self.mu,
                                       self.inv_sigma,
                                       proj_weight=self.pseudo_w,
                                       proj_bias=self.pseudo_b,
                                       use_tanh=True)
        else:
            if self.pseudo_w is not None:
                raise ValueError("flat pseudo-coordinates are projected "
                                 "outside the layer: build it with "
                                 "pseudo_proj=False")
            rst = gmm_aggregate(graph, x, pseudo, self.mu, self.inv_sigma)
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
    module names.

    ``pseudo`` names the form of the pseudo-coordinates the model takes
    (PSEUDO_MODES), which decides its parameters, as the flax MoNet's input
    does: "node" (a NodePseudo) and "binned" (``bin_pseudo``'s tables) keep
    each layer's projection inside the op; "flat" ([E, pseudo_in] in CSR
    edge order) projects with ``pseudo_projs["pseudo_proj_<i>"]`` + tanh
    before each layer.  ``gather_dtype`` applies in "node" mode only."""

    def __init__(self, in_feats: int, n_hidden: int, out_feats: int,
                 n_layers: int, dim: int, n_kernels: int, *,
                 dropout: float = 0.5, pseudo_in: int = 2,
                 pseudo: str = "node", gather_dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if pseudo not in PSEUDO_MODES:
            raise ValueError(f"pseudo must be one of {PSEUDO_MODES}, got "
                             f"{pseudo!r}")
        self.dropout = dropout
        self.pseudo = pseudo
        convs, projs = {}, {}
        width = in_feats
        for i, out in enumerate([n_hidden] * n_layers + [out_feats]):
            convs[f"gmm_{i}"] = GMMConv(
                width, out, dim, n_kernels, pseudo_in=pseudo_in,
                pseudo_proj=pseudo != "flat",
                gather_dtype=gather_dtype if pseudo == "node" else None,
                generator=generator)
            if pseudo == "flat":
                proj = nn.Linear(pseudo_in, dim)
                _lecun_normal_(proj.weight, pseudo_in, generator)
                with torch.no_grad():
                    proj.bias.zero_()
                projs[f"pseudo_proj_{i}"] = proj
            width = out
        self.convs = nn.ModuleDict(convs)
        self.pseudo_projs = nn.ModuleDict(projs) if projs else None

    def forward(self, graph: Graph, feat: torch.Tensor, pseudo, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits [N, out_feats].  In training, ``generator`` draws the
        feature dropout."""
        if _mode_of(pseudo) != self.pseudo:
            raise TypeError(f"this MoNet takes pseudo={self.pseudo!r} "
                            f"coordinates, got the {_mode_of(pseudo)!r} form")
        h = feat
        for i, conv in enumerate(self.convs.values()):
            if i != 0 and self.training and self.dropout > 0.0:
                h = _dropout(h, self.dropout, generator)
            p = pseudo
            if self.pseudo_projs is not None:
                p = torch.tanh(self.pseudo_projs[f"pseudo_proj_{i}"](pseudo))
            h = conv(graph, h, p)
        return h
