"""Host-side graph preprocessing: COO -> CSR/CSC + edge permutation.

Port of ``dgnn_tpu/graph/build.py``.  The sorts run in the port's native
library (dgnn_tpu_torch/native: O(E) counting sorts) where it is
available, else in numpy (``_coo_to_csr_numpy``,
``_csr_to_csc_permute_numpy``); both give the same arrays.  All index
construction happens once on the host; the results are uploaded as torch
tensors by graph/structure.py.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..utils.profiling import span

__all__ = [
    "coo_to_csr",
    "csr_to_csc_permute",
    "add_self_loops",
    "remove_self_loops",
]


def _as_int64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int64)


def coo_to_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """Build CSR over *destination* rows: row i lists source nodes of edges
    into i (the aggregation direction used by every layer).

    Returns (row_ptr[int64 N+1], col_ind[int32 E]) with columns sorted within
    each row and edge ids implicitly 0..E-1 in CSR order.
    """
    src = _as_int64(src)
    dst = _as_int64(dst)
    if src.shape[0] >= np.iinfo(np.int32).max:
        raise ValueError("per-shard edge count must fit int32")
    with span("dgnn.graph.csr"):
        if native.available():
            return native.coo_to_csr(src, dst, num_nodes)
        return _coo_to_csr_numpy(src, dst, num_nodes)


def _coo_to_csr_numpy(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """coo_to_csr's numpy version, on int64 ``src`` / ``dst``."""
    # Sort edges by (dst, src): stable lexsort, primary key last.
    order = np.lexsort((src, dst))
    col_ind = src[order].astype(np.int32)
    counts = np.bincount(dst, minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr, col_ind


def csr_to_csc_permute(row_ptr: np.ndarray, col_ind: np.ndarray):
    """Transpose a CSR graph, tracking where each CSR edge lands.

    Returns (col_ptr[int64 N+1], row_ind[int32 E], permute[int32 E]) where
    ``permute[j]`` is the CSR edge id stored at CSC slot ``j``.
    """
    with span("dgnn.graph.csc"):
        if native.available():
            return native.csr_to_csc_permute(row_ptr, col_ind)
        return _csr_to_csc_permute_numpy(row_ptr, col_ind)


def _csr_to_csc_permute_numpy(row_ptr: np.ndarray, col_ind: np.ndarray):
    """csr_to_csc_permute's numpy version."""
    num_nodes = row_ptr.shape[0] - 1
    row_of_edge = np.repeat(
        np.arange(num_nodes, dtype=np.int64), np.diff(row_ptr).astype(np.int64)
    )
    order = np.lexsort((row_of_edge, col_ind.astype(np.int64)))
    permute = order.astype(np.int32)
    row_ind = row_of_edge[order].astype(np.int32)
    counts = np.bincount(col_ind.astype(np.int64), minlength=num_nodes)
    col_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=col_ptr[1:])
    return col_ptr, row_ind, permute


def remove_self_loops(src: np.ndarray, dst: np.ndarray):
    src = _as_int64(src)
    dst = _as_int64(dst)
    keep = src != dst
    return src[keep], dst[keep]


def add_self_loops(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """Append one (i, i) edge per node."""
    loop = np.arange(num_nodes, dtype=np.int64)
    return (np.concatenate([_as_int64(src), loop]),
            np.concatenate([_as_int64(dst), loop]))
