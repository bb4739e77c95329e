"""The reddit-scale graph of the JAX bench, built and cached without JAX.

Reddit itself is not in the repository, so the JAX bench and trainers run
an R-MAT power-law graph at its size (``CITATION_SHAPES["reddit"]``:
232,965 nodes, 114,615,892 edges before self loops) with a task derived
from its own edges (``structure_task_from_csr``).  The host build is two
levels of cache under ``.bench_cache/`` at the root of the checkout, as
``bench.py`` keeps them, under the port's own names:

- ``rmat_raw_{n}_{e}_torch.npz``: the raw CSR / CSC / permute arrays
  (``build_raw``; the keys and dtypes of ``scripts/build_reddit_raw.py``);
- ``rmat_graph_{n}_{e}_d6_{key}_torch.npz``: the binned graph with its hub
  block (``dense="auto"``, no edge tables), in graph/cache.py's layout;
  ``key`` (``graph_key``) hashes the constants that layout depends on, so a
  graph built under other constants is rebuilt, never loaded.

``scale`` cuts both counts as the bench's ``BENCH_SCALE`` does
(``bench.py:122-125``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
import resource
from pathlib import Path

import numpy as np

from ..graph import binning as _binning
from ..graph import build as _gbuild
from ..graph import hub as _hub
from ..graph.cache import LAYOUT, load_graph, save_graph
from ..graph.structure import Graph, build_graph_from_csr
from ..utils.profiling import last, span
from .synthetic import CITATION_SHAPES, rmat_edges, structure_task_from_csr

__all__ = ["RedditData", "reddit_size", "build_raw", "load_reddit",
           "graph_key", "CACHE_DIR"]

CACHE_DIR = Path(__file__).resolve().parents[2] / ".bench_cache"


def reddit_size(scale: float = 1.0) -> tuple[int, int]:
    """(nodes, edges before self loops) of the reddit graph at ``scale``."""
    n, e, _, _ = CITATION_SHAPES["reddit"]
    return int(n * scale), int(e * scale)


def graph_key() -> str:
    """A short hash of what the cached graph depends on beyond its size:
    the degree binning's and the hub planner's module constants and the
    defaults of the functions that build it (read now, so a constant
    changed at run time changes the key too), and the file layout."""
    parts = {"layout": LAYOUT}
    for mod in (_binning, _hub):
        for name, value in vars(mod).items():
            if (name.lstrip("_").isupper() and not name.startswith("__")
                    and isinstance(value, (int, float, tuple))):
                parts[f"{mod.__name__}.{name}"] = value
    for fn in (_binning.auto_widths, _hub.plan_dense, build_graph_from_csr):
        for name, par in inspect.signature(fn).parameters.items():
            if par.default is not inspect.Parameter.empty:
                parts[f"{fn.__name__}.{name}"] = par.default
    blob = json.dumps(parts, sort_keys=True, default=repr).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def _stage(seconds: dict, name: str, *spans: str, log) -> None:
    """``seconds[name]``: the seconds of the recorder's newest spans named
    ``spans`` (utils/profiling.py), summed and logged."""
    seconds[name] = sum(last(s).seconds for s in spans)
    log(f"{name} {seconds[name]:.1f}s")


def build_raw(n: int, e: int, out_path: str, seed: int = 0,
              log=print) -> dict:
    """R-MAT edges -> self loops -> CSR -> CSC + permute, written to
    ``out_path`` (atomically) with the keys and dtypes of
    ``scripts/build_reddit_raw.py``.  Returns the seconds each stage took,
    from the recorder's spans (``log`` prints each as it ends)."""
    seconds = {}
    src, dst = rmat_edges(n, e, seed=seed)
    _stage(seconds, "rmat edges", "dgnn.data.rmat", log=log)
    with span("dgnn.data.reddit.csr"):
        src, dst = _gbuild.remove_self_loops(src, dst)
        src, dst = _gbuild.add_self_loops(src, dst, n)
        row_ptr, col_ind = _gbuild.coo_to_csr(src, dst, n)
    _stage(seconds, "csr", "dgnn.data.reddit.csr", log=log)
    del src, dst
    col_ptr, row_ind, permute = _gbuild.csr_to_csc_permute(row_ptr, col_ind)
    _stage(seconds, "csc+permute", "dgnn.graph.csc", log=log)
    with span("dgnn.data.reddit.save_raw"):
        meta = dict(num_nodes=n, num_edges=int(col_ind.shape[0]), seed=seed)
        tmp = out_path + ".tmp.npz"
        np.savez(tmp, row_ptr=row_ptr.astype(np.int64),
                 col_ind=col_ind.astype(np.int32),
                 col_ptr=col_ptr.astype(np.int64),
                 row_ind=row_ind.astype(np.int32),
                 permute=permute.astype(np.int32),
                 meta_json=np.frombuffer(json.dumps(meta).encode(),
                                         np.uint8))
        os.replace(tmp, out_path)
    _stage(seconds, "saved raw", "dgnn.data.reddit.save_raw", log=log)
    return seconds


@dataclasses.dataclass
class RedditData:
    graph: Graph             # CPU tensors, raw CSR / CSC kept
    features: np.ndarray     # [N, F] float32
    labels: np.ndarray       # [N] int32
    train_mask: np.ndarray   # [N] bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    n_classes: int
    seconds: dict            # host set-up seconds by stage, from spans:
    #                          the build's and the cache's stages hold the
    #                          raw arrays' load too
    host_peak_mb: float      # the process's peak resident memory so far


def load_reddit(scale: float = 1.0, seed: int = 0,
                cache_dir: str | os.PathLike | None = None,
                log=print) -> RedditData:
    """The reddit graph at ``scale`` from the port's cache, building and
    caching what is missing (the raw arrays, then the binned graph), and
    its task from ``structure_task_from_csr`` on the raw CSR."""
    cache = Path(cache_dir) if cache_dir is not None else CACHE_DIR
    cache.mkdir(parents=True, exist_ok=True)
    n, e = reddit_size(scale)
    _, _, n_feats, n_classes = CITATION_SHAPES["reddit"]
    raw_path = cache / f"rmat_raw_{n}_{e}_torch.npz"
    graph_path = cache / (f"rmat_graph_{n}_{e}_{LAYOUT}_{graph_key()}"
                          "_torch.npz")
    seconds = {}
    if not raw_path.exists():
        seconds.update(build_raw(n, e, str(raw_path), log=log))
    with span("dgnn.data.reddit.raw"), np.load(raw_path) as z:
        raw = {k: z[k] for k in ("row_ptr", "col_ind", "col_ptr", "row_ind",
                                 "permute")}
    if not graph_path.exists():
        graph = build_graph_from_csr(raw["row_ptr"], raw["col_ind"],
                                     raw["col_ptr"], raw["row_ind"],
                                     raw["permute"], dense="auto",
                                     edge_tables=False)
        _stage(seconds, "bins + hub block", "dgnn.graph.build", log=log)
        save_graph(str(graph_path), graph)
        _stage(seconds, "bins + hub block + save", "dgnn.data.reddit.raw",
               "dgnn.graph.build", "dgnn.graph.cache.save", log=log)
    else:
        graph = load_graph(str(graph_path))
        _stage(seconds, "cache load", "dgnn.data.reddit.raw",
               "dgnn.graph.cache.load", log=log)
    with span("dgnn.data.reddit.task"):
        feats, labels, tr, va, te = structure_task_from_csr(
            raw["row_ptr"], raw["col_ind"], n_classes, n_feats, seed=seed)
    _stage(seconds, "task", "dgnn.data.reddit.task", log=log)
    # ru_maxrss is in KiB on Linux
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    return RedditData(graph=graph, features=feats, labels=labels,
                      train_mask=tr, val_mask=va, test_mask=te,
                      n_classes=n_classes, seconds=seconds,
                      host_peak_mb=peak)
