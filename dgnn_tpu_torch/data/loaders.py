"""Citation dataset loader: real data from disk when given, else synthetic.

Port of ``dgnn_tpu/data/loaders.py:load_citation_dataset``.  A real
dataset is an ``.npz`` with arrays {src, dst, features, labels, train_mask,
val_mask, test_mask} (planetoid-style) under the directory named by
``$DGNN_TPU_DATA``.  Unlike the JAX package, no default directory under the
home directory is searched: without the variable the synthetic generator
is used.
"""

from __future__ import annotations

import os

import numpy as np

from . import synthetic

__all__ = ["load_citation_dataset"]


def load_citation_dataset(name: str, seed: int = 0) -> synthetic.CitationData:
    root = os.environ.get("DGNN_TPU_DATA")
    path = os.path.join(root, f"{name}.npz") if root else None
    if path is not None and os.path.exists(path):
        z = np.load(path)
        return synthetic.CitationData(
            src=z["src"], dst=z["dst"], num_nodes=int(z["features"].shape[0]),
            features=z["features"].astype(np.float32),
            labels=z["labels"].astype(np.int32),
            train_mask=z["train_mask"], val_mask=z["val_mask"],
            test_mask=z["test_mask"],
            n_classes=int(z["labels"].max()) + 1,
        )
    return synthetic.synthetic_citation(name, seed=seed)
