"""CSV result rows with the JAX package's schema
(``name,config,train_s,infer_s,maxMB,acc``, dgnn_tpu/utils/logging.py)."""

from __future__ import annotations

import os

__all__ = ["append_csv_row"]

_HEADER = (
    "# name,config,train_s_per_epoch,inference_s,peak_MB,test_accuracy\n"
    "# Datasets are synthetic generators at the real datasets' scale and\n"
    "# statistics (dgnn_tpu_torch/data/synthetic.py), so accuracies are\n"
    "# comparable across this table's rows, not with published results.\n")


def append_csv_row(path: str, name: str, config: str, train_s: float,
                   infer_s: float, max_mb: float, acc: float) -> None:
    header = _HEADER if not os.path.exists(path) else ""
    with open(path, "a") as f:
        f.write(header)
        print(f"{name},{config},{train_s:f}s,{infer_s:f}s,{max_mb:.0f}MB,{acc}",
              file=f)
