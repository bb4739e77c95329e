"""MoNet as ``configs/monet.json`` states it: the weights the benchmark
makes, the port's model that runs it (node pseudo-coordinates
deg^-1/2, as ``scripts/train_gmm_torch.py`` ``node_pseudo`` makes them),
and its operations and bytes.

Counts are from the graph's node and edge counts (N, E, self loops
included) and the widths alone, per the layer equations
(``reference/monet.py``).  A multiply-add is 2 operations; an exp or a
tanh 1.
"""

import math

from gnnbench.program import Program as _Program

__all__ = ["leaves", "Program", "mp_passes", "model_flops", "layer_dims"]

_GAIN = math.sqrt(2.0)


def layer_dims(cfg: dict, in_feats: int, n_classes: int) -> list:
    """(name, in width, width) of each layer."""
    widths = [cfg["n_hidden"]] * cfg["n_layers"] + [n_classes]
    ins = [in_feats] + widths[:-1]
    return [(f"gmm_{i}", a, b) for i, (a, b) in enumerate(zip(ins, widths))]


def leaves(cfg: dict, in_feats: int, n_classes: int) -> list:
    """(name, shape, init) of every weight, as the port's MoNet holds it."""
    k, d = cfg["n_kernels"], cfg["dim"]
    out = []
    for name, i, f in layer_dims(cfg, in_feats, n_classes):
        out += [(f"{name}.fc", (k * f, i),
                 ("normal", _GAIN * math.sqrt(2.0 / (i + k * f)))),
                (f"{name}.mu", (k, d), ("normal", 0.1)),
                (f"{name}.inv_sigma", (k, d), ("ones",)),
                (f"{name}.pseudo_w", (2, d), ("normal", math.sqrt(0.5))),
                (f"{name}.pseudo_b", (d,), ("zeros",)),
                (f"{name}.bias", (f,), ("zeros",))]
    return out


class Program(_Program):
    def prepare(self, graph):
        from dgnn_tpu_torch.ops.gmm import NodePseudo

        deg = graph.in_degrees().to(self.device).float().clamp(min=1.0)
        rsq = deg.rsqrt()[:, None]
        self.pseudo = NodePseudo(src=rsq, dst=rsq)
        return super().prepare(graph)

    def build_model(self, in_feats: int, n_classes: int):
        from dgnn_tpu_torch.models import MoNet

        c = self.cfg
        return MoNet(in_feats, c["n_hidden"], n_classes, c["n_layers"],
                     c["dim"], c["n_kernels"], dropout=c["dropout"],
                     pseudo_in=2, pseudo="node",
                     gather_dtype=self.traffic["gather_dtype"])

    def param_name(self, leaf: str) -> str:
        layer, _, what = leaf.partition(".")
        return f"convs.{layer}.{'fc.weight' if what == 'fc' else what}"

    def logits(self, generator):
        return self.model(self.graph, self.feats, self.pseudo,
                          generator=generator)


def mp_passes(cfg: dict, n: int, e: int, in_feats: int, n_classes: int,
              gather_bytes: int, mode: str) -> list:
    """(operations, bytes) of each message-passing pass of a step, in the
    order they run.  Bytes: each input read once (the feature rows in the
    gathered type, the node scalar, the edges' source ids and the rows'
    offsets), each output written once (float32)."""
    k, d = cfg["n_kernels"], cfg["dim"]
    fwd, bwd = [], []
    for _, _, f in layer_dims(cfg, in_feats, n_classes):
        graph = 4 * e + 8 * (n + 1)
        rows = n * k * f
        # projection + tanh, K Gaussian weights, the K weighted sums
        fwd.append((e * (5 * d + k * (4 * d + 2) + 2 * k * f),
                    rows * gather_bytes + 4 * n + graph + 4 * rows))
        # dx, d(weight) = <g, x>, the Gaussians' and projection's chain
        bwd.append((e * (4 * k * f + 6 * k * d + 6 * d),
                    4 * rows + rows * gather_bytes + 4 * n + graph
                    + 4 * rows))
    return fwd + (bwd[::-1] if mode == "train" else [])


def model_flops(cfg: dict, n: int, e: int, in_feats: int, n_classes: int,
                mode: str) -> float:
    """Operations of a step: the projections and the message passing,
    forward and (training) backward, counted once.  The first layer's
    input is data: no gradient is formed for it."""
    k = cfg["n_kernels"]
    total = sum(f for f, _ in mp_passes(cfg, n, e, in_feats, n_classes, 4,
                                        mode))
    for j, (_, i, f) in enumerate(layer_dims(cfg, in_feats, n_classes)):
        proj = 2 * n * i * k * f
        total += proj
        if mode == "train":
            total += proj + (proj if j > 0 else 0)
    return float(total)
