"""The plain reference of ``configs/gat_reddit.json``: the same GAT as
``configs/gat.json``, so ``reference/gat.py``."""

from gnnbench.reference.gat import forward, infer, layers, train

__all__ = ["layers", "forward", "train", "infer"]
