"""Dataset loaders: real data from disk when given, else synthetic.

Port of ``dgnn_tpu/data/loaders.py``.  A real citation dataset is an
``.npz`` with arrays {src, dst, features, labels, train_mask, val_mask,
test_mask} (planetoid-style) under ``data_dir()``: ``$DGNN_TPU_DATA``, else
``~/.dgnn_tpu/data``, as in the JAX package; ModelNet40 is
``modelnet40-sampled-2048.h5`` there (or at an explicit ``path``), with
train/data, train/label, test/data and test/label, read if h5py is
importable.  Without such a file the synthetic generators are used.
"""

from __future__ import annotations

import os

import numpy as np

from . import synthetic

__all__ = ["load_citation_dataset", "load_modelnet", "data_dir"]


def data_dir() -> str:
    """Where real data sets are looked for: ``$DGNN_TPU_DATA``, else
    ``~/.dgnn_tpu/data``."""
    return os.environ.get("DGNN_TPU_DATA",
                          os.path.expanduser("~/.dgnn_tpu/data"))


def load_citation_dataset(name: str, seed: int = 0) -> synthetic.CitationData:
    path = os.path.join(data_dir(), f"{name}.npz")
    if os.path.exists(path):
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


def load_modelnet(num_points: int = 1024, path: str | None = None,
                  train_samples: int = 512, test_samples: int = 128,
                  seed: int = 0):
    """Returns (x_train, y_train, x_test, y_test): [S, P, 3] float32 clouds
    and [S] int32 labels."""
    path = path or os.path.join(data_dir(), "modelnet40-sampled-2048.h5")
    if os.path.exists(path):
        try:
            import h5py  # optional dependency

            with h5py.File(path, "r") as f:
                xtr = f["train/data"][:, :num_points].astype(np.float32)
                ytr = f["train/label"][:].squeeze().astype(np.int32)
                xte = f["test/data"][:, :num_points].astype(np.float32)
                yte = f["test/label"][:].squeeze().astype(np.int32)
            return xtr, ytr, xte, yte
        except ImportError:
            pass
    # shared class templates, disjoint instance seeds (train and test must
    # describe the SAME classes for test accuracy to mean anything)
    xtr, ytr = synthetic.synthetic_point_clouds(train_samples, num_points,
                                                seed=seed, template_seed=seed)
    xte, yte = synthetic.synthetic_point_clouds(test_samples, num_points,
                                                seed=seed + 1,
                                                template_seed=seed)
    return xtr, ytr, xte, yte
