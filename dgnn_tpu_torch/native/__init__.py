"""ctypes bindings for the port's native graph-preprocessing library.

``graph_prep.cc`` (beside this file) holds O(E) counting sorts for the CSR
and the CSC with its permutation, the degree bins' slot fill, the hub
block's bit-mask fill and an R-MAT generator (``rmat_edges``, the JAX
package's xoshiro256** generator bit for bit).  The host graph build calls
the first four where the library is available:
``graph/build.py`` ``coo_to_csr`` / ``csr_to_csc_permute``,
``graph/binning.py`` ``_build_bin`` and ``graph/hub.py``
``build_dense_numpy``.  Each keeps its numpy version beside the call; both
give the same arrays.  ``tile_row_edges`` counts the set bits of each tile
row of a built hub block, for the work list of the hub-block MoNet kernels
(``ops/dense.py`` ``gmm_work``, which runs only beside a card, where the
library builds).  ``rmat_edges`` draws from another PRNG than the
numpy ``data/synthetic.py`` ``rmat_edges`` and so gives another graph;
the reddit build keeps the numpy generator, as the JAX package's does.

The library is compiled with ``g++`` at first use into
``build/dgnn_tpu_torch/native/<hash>/`` at the root of the checkout (listed
in .gitignore), keyed by a hash of the source and the flags, and loaded
once a process.  Nothing is built or loaded at import time, and nothing is
written beside the source.

``available()`` is false when no ``g++`` is on the PATH, or when
``DGNN_TPU_NATIVE=0`` turns the library off; the graph code then takes its
numpy versions.  With ``g++`` present a failed build or load raises.

``CALLS`` counts the calls into the library per function, so that a run
can show its host build went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "build", "load", "library_path", "coo_to_csr",
           "csr_to_csc_permute", "bin_fill", "dense_mask_fill", "rmat_edges",
           "tile_row_edges", "CALLS",
           "reset_calls", "CXX_FLAGS"]

_SRC = Path(__file__).resolve().parent / "graph_prep.cc"
_BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
               / "dgnn_tpu_torch" / "native")
_LIB_NAME = "libdgnn_graph.so"

CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

CALLS = dict.fromkeys(("coo_to_csr", "csr_to_csc_permute", "bin_fill",
                       "dense_mask_fill", "rmat_edges", "tile_row_edges"), 0)

_lock = threading.Lock()
_lib = None


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def available() -> bool:
    """Whether the graph code should call the library: ``g++`` is on the
    PATH and ``DGNN_TPU_NATIVE`` is not "0"."""
    if os.environ.get("DGNN_TPU_NATIVE", "1") == "0":
        return False
    return shutil.which("g++") is not None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return _BUILD_ROOT / h.hexdigest()[:16] / _LIB_NAME


def build() -> Path:
    """Compile the library unless the one for this source exists."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on the PATH: the native graph "
                           "library cannot be built")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, check=False)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with code {res.returncode} on "
                           f"{_SRC}:\n{res.stdout[-4000:]}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def load() -> ctypes.CDLL:
    """Build if needed, load once a process, declare the C signatures."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64 = ctypes.c_int64
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.dgnn_coo_to_csr.argtypes = [i64, i64, i64p, i64p, i64p, i32p]
        lib.dgnn_csr_to_csc_permute.argtypes = [
            i64, i64, i64p, i32p, i64p, i32p, i32p]
        lib.dgnn_bin_fill.argtypes = [
            i64, i64, i64p, i64p, i32p, i64p, i32p, i32p]
        lib.dgnn_dense_mask_fill.argtypes = [i64, i64, i64, i64p, i64p, u8p]
        lib.dgnn_tile_row_edges.argtypes = [i64, i64, u8p, i32p]
        f64 = ctypes.c_double
        lib.dgnn_rmat.argtypes = [i64, i64, ctypes.c_uint64, f64, f64, f64,
                                  i64p, i64p]
        for fn in (lib.dgnn_coo_to_csr, lib.dgnn_csr_to_csc_permute,
                   lib.dgnn_bin_fill, lib.dgnn_dense_mask_fill,
                   lib.dgnn_tile_row_edges, lib.dgnn_rmat):
            fn.restype = None
        _lib = lib
        return lib


def _check_range(name: str, x: np.ndarray, hi: int) -> None:
    """Every entry of ``x`` in [0, hi): the library indexes with them."""
    if x.size and (int(x.min()) < 0 or int(x.max()) >= hi):
        raise ValueError(f"{name} holds ids outside [0, {hi})")


def coo_to_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """(row_ptr [N+1] int64, col_ind [E] int32): edges sorted by (dst,
    src), as graph/build.py's numpy version sorts them."""
    lib = load()
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src {src.shape} and dst {dst.shape} must be one "
                         "edge list")
    _check_range("src", src, num_nodes)
    _check_range("dst", dst, num_nodes)
    row_ptr = np.empty(num_nodes + 1, np.int64)
    col_ind = np.empty(src.shape[0], np.int32)
    lib.dgnn_coo_to_csr(num_nodes, src.shape[0], src, dst, row_ptr, col_ind)
    CALLS["coo_to_csr"] += 1
    return row_ptr, col_ind


def csr_to_csc_permute(row_ptr: np.ndarray, col_ind: np.ndarray):
    """(col_ptr [N+1] int64, row_ind [E] int32, permute [E] int32), as
    graph/build.py's numpy version gives them."""
    lib = load()
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    col_ind = np.ascontiguousarray(col_ind, dtype=np.int32)
    n = row_ptr.shape[0] - 1
    e = col_ind.shape[0]
    if n < 0 or row_ptr[0] != 0 or row_ptr[-1] != e \
            or (np.diff(row_ptr) < 0).any():
        raise ValueError("row_ptr is not a CSR row pointer over col_ind")
    _check_range("col_ind", col_ind, n)
    col_ptr = np.empty(n + 1, np.int64)
    row_ind = np.empty(e, np.int32)
    permute = np.empty(e, np.int32)
    lib.dgnn_csr_to_csc_permute(n, e, row_ptr, col_ind, col_ptr, row_ind,
                                permute)
    CALLS["csr_to_csc_permute"] += 1
    return col_ptr, row_ind, permute


def bin_fill(starts: np.ndarray, counts: np.ndarray, width: int,
             col_ind: np.ndarray, edge_ids: np.ndarray):
    """([S, width] nbr int32, [S, width] edge int32): segment s holds CSR
    slots [starts[s], starts[s] + counts[s]), zeros after them."""
    lib = load()
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    col_ind = np.ascontiguousarray(col_ind, dtype=np.int32)
    edge_ids = np.ascontiguousarray(edge_ids, dtype=np.int64)
    if starts.shape != counts.shape or col_ind.shape != edge_ids.shape:
        raise ValueError("starts/counts or col_ind/edge_ids differ in shape")
    if counts.size and (int(counts.min()) < 0 or int(counts.max()) > width
                        or int(starts.min()) < 0
                        or int((starts + counts).max()) > col_ind.shape[0]):
        raise ValueError(f"segments outside the {col_ind.shape[0]} CSR slots "
                         f"or wider than {width}")
    s = starts.shape[0]
    nbr = np.empty((s, width), np.int32)
    edge = np.empty((s, width), np.int32)
    lib.dgnn_bin_fill(s, width, starts, counts, col_ind, edge_ids, nbr, edge)
    CALLS["bin_fill"] += 1
    return nbr, edge


def dense_mask_fill(rows_local: np.ndarray, cols_local: np.ndarray,
                    rpad: int, cpad: int, ct: int) -> np.ndarray:
    """Bit-plane-packed [rpad, cpad // 8] uint8 mask with the bit of each
    (rows_local[i], cols_local[i]) set (graph/hub.py ``pack_mask_bits``'s
    layout for tiles of ``ct`` columns)."""
    lib = load()
    rows_local = np.ascontiguousarray(rows_local, dtype=np.int64)
    cols_local = np.ascontiguousarray(cols_local, dtype=np.int64)
    if rows_local.shape != cols_local.shape:
        raise ValueError("rows_local and cols_local differ in shape")
    if ct <= 0 or ct % 8 or cpad % ct:
        raise ValueError(f"ct {ct} must be a positive multiple of 8 that "
                         f"divides cpad {cpad}")
    _check_range("rows_local", rows_local, rpad)
    _check_range("cols_local", cols_local, cpad)
    mask = np.zeros((rpad, cpad // 8), np.uint8)
    lib.dgnn_dense_mask_fill(rows_local.shape[0], cpad, ct, rows_local,
                             cols_local, mask)
    CALLS["dense_mask_fill"] += 1
    return mask


def tile_row_edges(mask: np.ndarray) -> np.ndarray:
    """[T, RT] int32 set bits of each tile row of a packed [T, RT, CT // 8]
    uint8 hub-block mask (graph/hub.py's layout)."""
    lib = load()
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    if mask.ndim != 3 or mask.shape[2] % 8:
        raise ValueError(f"mask must be [T, RT, bytes] with bytes a multiple "
                         f"of 8, got {mask.shape}")
    counts = np.zeros(mask.shape[:2], np.int32)
    lib.dgnn_tile_row_edges(mask.shape[0] * mask.shape[1], mask.shape[2],
                            mask, counts)
    CALLS["tile_row_edges"] += 1
    return counts


def rmat_edges(num_nodes: int, num_edges: int, seed: int = 0, a: float = 0.57,
               b: float = 0.19, c: float = 0.19):
    """(src [E] int64, dst [E] int64): R-MAT edges with quadrant
    probabilities (a, b, c, 1 - a - b - c), symmetrised (the second half
    mirrors the first), node ids scrambled over [0, num_nodes); the same
    arrays as ``dgnn_tpu.native.rmat_edges`` for the same arguments."""
    lib = load()
    if num_nodes < 1 or num_edges < 0:
        raise ValueError(f"need num_nodes >= 1 and num_edges >= 0, got "
                         f"{num_nodes} and {num_edges}")
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} is not a uint64")
    probs = (a, b, c)
    if not all(0.0 <= p <= 1.0 for p in probs) or sum(probs) > 1.0:
        raise ValueError(f"probabilities {probs} must lie in [0, 1] and sum "
                         "to at most 1")
    src = np.empty(num_edges, np.int64)
    dst = np.empty(num_edges, np.int64)
    lib.dgnn_rmat(num_nodes, num_edges, seed, a, b, c, src, dst)
    CALLS["rmat_edges"] += 1
    return src, dst
