"""GAT as ``configs/gat.json`` states it: the weights the benchmark makes,
the port's model that runs it, and its operations and bytes.

Counts are from the graph's node and edge counts (N, E, self loops
included) and the widths alone, per the layer equations
(``reference/gat.py``), so they stay the same whatever implements them.
A multiply-add is 2 operations; an exp, a compare or a LeakyReLU 1.
"""

import math

from gnnbench.program import Program as _Program

__all__ = ["leaves", "Program", "mp_passes", "model_flops", "layer_dims"]

_GAIN = math.sqrt(2.0)  # the ReLU gain of the port's initialiser


def layer_dims(cfg: dict, in_feats: int, n_classes: int) -> list:
    """(name, in width, heads, width, has bias) of each layer."""
    out, width = [], in_feats
    for i in range(cfg["num_layers"]):
        h = cfg["heads"][i]
        out.append((f"gat_{i}", width, h, cfg["n_hidden"], i > 0))
        width = h * cfg["n_hidden"]
    return out + [("gat_out", width, cfg["heads"][-1], n_classes, True)]


def _fan_avg(fan_in: int, fan_out: int) -> float:
    return _GAIN * math.sqrt(2.0 / (fan_in + fan_out))


def leaves(cfg: dict, in_feats: int, n_classes: int) -> list:
    """(name, shape, init) of every weight, as the port's GAT holds it."""
    out = []
    for name, i, h, f, bias in layer_dims(cfg, in_feats, n_classes):
        out += [(f"{name}.W", (h * f, i), ("normal", _fan_avg(i, h * f))),
                (f"{name}.attn_l", (1, h, f), ("normal", _fan_avg(h, f))),
                (f"{name}.attn_r", (1, h, f), ("normal", _fan_avg(h, f)))]
        if bias:
            out.append((f"{name}.bias", (1, h, f), ("zeros",)))
    return out


class Program(_Program):
    def build_model(self, in_feats: int, n_classes: int):
        from dgnn_tpu_torch.models import GAT

        c = self.cfg
        return GAT(in_feats, c["num_layers"], c["n_hidden"], n_classes,
                   c["heads"], feat_drop=c["feat_drop"],
                   attn_drop=c["attn_drop"],
                   negative_slope=c["negative_slope"],
                   gather_dtype=self.traffic["gather_dtype"])

    def param_name(self, leaf: str) -> str:
        layer, _, what = leaf.partition(".")
        return f"convs.{layer}.{'W.weight' if what == 'W' else what}"

    def logits(self, generator):
        return self.model(self.graph, self.feats, generator=generator)


def mp_passes(cfg: dict, n: int, e: int, in_feats: int, n_classes: int,
              gather_bytes: int, mode: str) -> list:
    """(operations, bytes) of each message-passing pass of a step, in the
    order they run: each layer's forward, then (training) each layer's
    backward.  Bytes: each input read once (the feature rows in the
    gathered type, the two attention columns, the edges' source ids and
    the rows' offsets), each output written once (float32)."""
    fwd, bwd = [], []
    for _, _, h, f, _ in layer_dims(cfg, in_feats, n_classes):
        graph = 4 * e + 8 * (n + 1)
        cols = 2 * 4 * n * h
        # score, LeakyReLU, max, shift + exp, sum; weighted sum; divide
        fwd.append((e * h * (2 * f + 6) + n * h * f,
                    n * h * f * gather_bytes + cols + graph + 4 * n * h * f))
        # d(weight) = <g, x>, dx += weight g, softmax and LeakyReLU back
        bwd.append((e * h * (4 * f + 4),
                    4 * n * h * f + n * h * f * gather_bytes + cols + graph
                    + 4 * n * h * f + cols))
    return fwd + (bwd[::-1] if mode == "train" else [])


def model_flops(cfg: dict, n: int, e: int, in_feats: int, n_classes: int,
                mode: str) -> float:
    """Operations of a step: the projections, the attention columns and
    the message passing, forward and (training) backward, counted once.
    The first layer's input is data: no gradient is formed for it."""
    total = sum(f for f, _ in mp_passes(cfg, n, e, in_feats, n_classes, 4,
                                        mode))
    for k, (_, i, h, f, _) in enumerate(layer_dims(cfg, in_feats,
                                                   n_classes)):
        proj, cols = 2 * n * i * h * f, 2 * 2 * n * h * f
        total += proj + cols
        if mode == "train":
            total += proj + 2 * cols + (proj if k > 0 else 0)
    return float(total)
