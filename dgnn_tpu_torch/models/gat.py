"""GAT layer and network as ``nn.Module``s (port of ``dgnn_tpu/models/gat.py``).

Dense projection and attention-coefficient reductions are plain torch
(``nn.Linear``, elementwise products); everything sparse is the fused
``gat_aggregate`` op.  Semantics match the flax modules: bias only on
hidden layers after the first and on the output layer, the output layer
averaged over its heads, feature dropout on the projected features, and
on hidden layers only the optional residual (the input itself, or a
bias-free ``res_fc`` projection when the widths differ) and activation,
added and applied after the aggregation as flax adds them.

Init follows flax's ``variance_scaling(gain**2, "fan_avg", "normal")`` with
the ReLU gain.  For ``attn_l`` / ``attn_r`` of shape (1, H, F) flax takes
fan_in = H and fan_out = F (``torch.nn.init.xavier_normal_`` would take
fan_in = H*F), so the std is computed here the flax way.  Every random draw
(init, feature dropout) comes from an explicit ``torch.Generator``;
attention dropout takes one uint32 seed per layer: Python ints, or a [L]
integer tensor on the model's device that a step draws there (so that a
CUDA graph of the step draws new seeds on every replay).

``impl`` picks the aggregation: "fused" (the default) is ``gat_aggregate``
over the binned layouts and hub blocks; "naive" is ``ops/naive.py``'s
``gat_naive``, the DGL-style baseline that materialises per-edge tensors
and reads the raw CSR (so the graph must not be slim).  ``gather_dtype``
("bfloat16" halves the gathered feature rows; sums stay float32) is
handed to every layer's ``gat_aggregate``, as the flax modules hand it to
the fused op; the naive path ignores it, as the flax modules do.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn

from ..graph.structure import Graph
from ..ops.gat import gat_aggregate
from ..ops.naive import gat_naive

__all__ = ["GATConv", "GAT", "IMPLS"]

IMPLS = ("fused", "naive")

_GAIN_RELU = math.sqrt(2.0)


def _fan_avg_normal_(t: torch.Tensor, fan_in: int, fan_out: int,
                     generator: torch.Generator | None):
    std = _GAIN_RELU * math.sqrt(2.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


def _dropout(x, p: float, generator: torch.Generator | None):
    """Inverted dropout as flax's nn.Dropout: keep with prob 1 - p."""
    if generator is None:
        raise ValueError("feature dropout in training needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


class GATConv(nn.Module):
    """Multi-head graph attention layer over the fused aggregation.

    Output: [N, num_heads, out_feats]."""

    def __init__(self, in_feats: int, out_feats: int, num_heads: int, *,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2, residual: bool = False,
                 activation: Callable | None = None, use_bias: bool = True,
                 impl: str = "fused", gather_dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.impl = impl
        self.out_feats = out_feats
        self.num_heads = num_heads
        self.gather_dtype = gather_dtype
        self.feat_drop = feat_drop
        self.attn_drop = attn_drop
        self.negative_slope = negative_slope
        self.residual = residual
        self.activation = activation
        hf = num_heads * out_feats
        self.W = nn.Linear(in_feats, hf, bias=False)
        _fan_avg_normal_(self.W.weight, in_feats, hf, generator)
        self.attn_l = nn.Parameter(torch.empty(1, num_heads, out_feats))
        self.attn_r = nn.Parameter(torch.empty(1, num_heads, out_feats))
        _fan_avg_normal_(self.attn_l, num_heads, out_feats, generator)
        _fan_avg_normal_(self.attn_r, num_heads, out_feats, generator)
        self.res_fc = None
        if residual and in_feats != hf:
            self.res_fc = nn.Linear(in_feats, hf, bias=False)
            _fan_avg_normal_(self.res_fc.weight, in_feats, hf, generator)
        self.bias = (nn.Parameter(torch.zeros(1, num_heads, out_feats))
                     if use_bias else None)

    def forward(self, graph: Graph, feat: torch.Tensor, *,
                generator: torch.Generator | None = None,
                seed=None) -> torch.Tensor:
        x = self.W(feat).reshape(-1, self.num_heads, self.out_feats)
        if self.training and self.feat_drop > 0.0:
            x = _dropout(x, self.feat_drop, generator)
        attn_row = (self.attn_l * x).sum(dim=-1)  # [N, H] dst coefficients
        attn_col = (self.attn_r * x).sum(dim=-1)  # [N, H] src coefficients
        kw = {}
        agg = gat_naive
        if self.impl == "fused":
            agg, kw = gat_aggregate, dict(gather_dtype=self.gather_dtype)
        rst = agg(graph, attn_row, attn_col, x,
                  negative_slope=self.negative_slope,
                  attn_drop=self.attn_drop, seed=seed,
                  training=self.training, **kw)
        if self.residual:
            res = feat if self.res_fc is None else self.res_fc(feat)
            rst = rst + res.reshape(-1, self.num_heads, self.out_feats)
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        return rst


class GAT(nn.Module):
    """Multi-layer GAT: ``num_layers`` hidden layers with ``heads[l]`` heads
    whose outputs are flattened, then an output layer averaged over its
    heads.  ``residual`` and ``activation`` apply to the hidden layers
    only, as in the flax model.  Layers are ``convs["gat_0"] ...
    convs["gat_out"]``, the flax module names."""

    def __init__(self, in_feats: int, num_layers: int, n_hidden: int,
                 n_classes: int, heads: Sequence[int], *,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2, residual: bool = False,
                 activation: Callable | None = None, impl: str = "fused",
                 gather_dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.attn_drop = attn_drop
        convs = {}
        dim = in_feats
        for layer in range(num_layers):
            convs[f"gat_{layer}"] = GATConv(
                dim, n_hidden, heads[layer], feat_drop=feat_drop,
                attn_drop=attn_drop, negative_slope=negative_slope,
                residual=residual, activation=activation,
                use_bias=layer > 0,  # the input projection has no bias
                impl=impl, gather_dtype=gather_dtype, generator=generator)
            dim = n_hidden * heads[layer]
        convs["gat_out"] = GATConv(
            dim, n_classes, heads[-1], feat_drop=feat_drop,
            attn_drop=attn_drop, negative_slope=negative_slope, impl=impl,
            gather_dtype=gather_dtype, generator=generator)
        self.convs = nn.ModuleDict(convs)

    def forward(self, graph: Graph, feat: torch.Tensor, *,
                generator: torch.Generator | None = None,
                attn_seeds: Sequence[int] | torch.Tensor | None = None
                ) -> torch.Tensor:
        """Logits [N, n_classes].  In training, ``generator`` draws the
        feature dropout and ``attn_seeds`` holds one uint32 attention-dropout
        seed per layer (required when attn_drop > 0): a sequence of ints or
        a [L] integer tensor on the model's device, read as uint32."""
        if self.training and self.attn_drop > 0.0:
            if attn_seeds is None or len(attn_seeds) != len(self.convs):
                raise ValueError(f"attention dropout in training needs "
                                 f"{len(self.convs)} attn_seeds, one per layer")
        h = feat
        for i, (name, conv) in enumerate(self.convs.items()):
            seed = attn_seeds[i] if attn_seeds is not None else None
            h = conv(graph, h, generator=generator, seed=seed)
            if name != "gat_out":
                h = h.reshape(h.shape[0], -1)
        return h.mean(dim=1)
