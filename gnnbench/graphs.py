"""The benchmark's graphs: made from a traffic file's parameters, cached
in a fixed directory, and handed to the port's host build.

The generators are numpy copies of the port's (``dgnn_tpu_torch/data/
synthetic.py`` ``rmat_edges`` and the edge part of ``synthetic_citation``),
kept here so that a change to the port cannot move the yardstick.  Every
graph is made simple: self loops and duplicate draws are removed, then one
self loop is added to every node, as the real datasets (Reddit, Planetoid
PubMed) have no multi-edges and the port's layers add self loops.  The
graph depends on the traffic file alone (its ``graph_seed``), never on a
run's ``--seed``: the work of a step is the same on every seed.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path

import numpy as np

__all__ = ["rmat_edges", "citation_edges", "simple_csr", "load_csr",
           "port_graph", "GraphData"]


def rmat_edges(num_nodes: int, num_edges: int, seed: int, a: float = 0.57,
               b: float = 0.19, c: float = 0.19):
    """R-MAT power-law edges (Graph500 quadrants), symmetrised: a copy of
    ``dgnn_tpu_torch.data.synthetic.rmat_edges`` (same draws, same ids)."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(num_nodes, 2))))
    n_half = num_edges // 2 + 1
    src = np.zeros(n_half, dtype=np.int64)
    dst = np.zeros(n_half, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(n_half)
        right = r >= a + b
        down = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src = (src << 1) | down.astype(np.int64)
        dst = (dst << 1) | right.astype(np.int64)
    src %= num_nodes
    dst %= num_nodes
    perm = rng.permutation(num_nodes)
    src, dst = perm[src], perm[dst]
    s = np.concatenate([src, dst])[:num_edges]
    d = np.concatenate([dst, src])[:num_edges]
    return s, d


def citation_edges(num_nodes: int, num_edges: int, n_classes: int,
                   seed: int, homophily: float = 0.7):
    """Uniform random edges with homophilous rewiring: the edge part of
    ``dgnn_tpu_torch.data.synthetic.synthetic_citation`` (same draws in the
    same order, so the same edges for the same seed)."""
    n, e, c = num_nodes, num_edges, n_classes
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, n).astype(np.int32)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    order = np.argsort(labels, kind="stable")
    class_start = np.searchsorted(labels[order], np.arange(c))
    class_count = np.bincount(labels, minlength=c)
    rewire = rng.random(len(src)) < homophily
    cls = labels[src[rewire]]
    offs = (rng.random(rewire.sum()) * class_count[cls]).astype(np.int64)
    dst = dst.copy()
    dst[rewire] = order[class_start[cls] + offs]
    return src, dst


def simple_csr(src, dst, num_nodes: int, log=None):
    """CSR over destination rows (row v lists the sources of edges into v,
    columns ascending) of the simple graph: no self loop or duplicate from
    the draws, then one self loop a node.  Returns (row_ptr int64 [N+1],
    col_ind int32 [E]).  ``log``, where given, hears each stage's
    seconds."""
    t0 = time.perf_counter()

    def stage(name):
        if log is not None:
            log(f"setup stage simple csr, {name}: "
                f"{time.perf_counter() - t0:.3f} s")

    n = np.int64(num_nodes)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    keep = src != dst
    key = dst[keep] * n
    key += src[keep]
    del keep
    stage("keys")
    key.sort()
    stage("sort")
    first = np.empty(key.shape, bool)
    first[:1] = True
    np.not_equal(key[1:], key[:-1], out=first[1:])
    key = key[first]
    del first
    stage("distinct")
    loops = np.arange(n, dtype=np.int64) * (n + 1)
    key = np.insert(key, np.searchsorted(key, loops), loops)
    stage("self loops")
    counts = np.bincount(key // n, minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr, (key % n).astype(np.int32)


class GraphData:
    """A traffic file's graph on the host: ``row_ptr``, ``col_ind``, the
    node and edge counts, the feature and class counts, ``sha`` (of the
    CSR) and the seconds of each stage that ran."""

    def __init__(self, row_ptr, col_ind, n_feats, n_classes, sha, seconds):
        self.row_ptr, self.col_ind = row_ptr, col_ind
        self.num_nodes = len(row_ptr) - 1
        self.num_edges = int(col_ind.shape[0])
        self.n_feats, self.n_classes = n_feats, n_classes
        self.sha, self.seconds = sha, seconds


def _graph_params(traffic: dict) -> dict:
    return {k: traffic[k] for k in ("generator", "num_nodes", "edge_draws",
                                    "n_feats", "n_classes", "graph_seed")}


def load_csr(traffic: dict, cache_dir: Path, log=print) -> GraphData:
    """The traffic's simple graph, from ``cache_dir`` or made and cached
    there (atomically); its edge count, self loops included, held to the
    traffic's ``num_edges`` where it states one."""
    p = _graph_params(traffic)
    blob = json.dumps(p, sort_keys=True).encode()
    name = f"csr_{p['generator']}_{hashlib.sha256(blob).hexdigest()[:16]}"
    path = Path(cache_dir) / f"{name}.npz"
    seconds = {}
    t0 = time.perf_counter()
    if path.exists():
        with np.load(path) as z:
            row_ptr, col_ind = z["row_ptr"], z["col_ind"]
            sha = bytes(z["sha"]).decode()
        seconds["csr load"] = time.perf_counter() - t0
    else:
        n, e = p["num_nodes"], p["edge_draws"]
        if p["generator"] == "rmat":
            src, dst = rmat_edges(n, e, p["graph_seed"])
        elif p["generator"] == "citation":
            src, dst = citation_edges(n, e, p["n_classes"], p["graph_seed"])
        else:
            raise ValueError(f"unknown graph generator {p['generator']!r}")
        seconds["edges"] = time.perf_counter() - t0
        row_ptr, col_ind = simple_csr(src, dst, n, log)
        del src, dst
        seconds["simple csr"] = time.perf_counter() - t0
        h = hashlib.sha256(row_ptr.tobytes())
        h.update(col_ind.tobytes())
        sha = h.hexdigest()
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp.npz")
        np.savez(tmp, row_ptr=row_ptr, col_ind=col_ind,
                 sha=np.frombuffer(sha.encode(), np.uint8))
        os.replace(tmp, path)
        seconds["csr saved"] = time.perf_counter() - t0
    for k, v in seconds.items():
        log(f"setup stage {k}: {v:.3f} s")
    log(f"graph: {len(row_ptr) - 1} nodes, {col_ind.shape[0]} edges with "
        f"the self loops")
    stated = traffic.get("num_edges")
    if stated is not None and stated != col_ind.shape[0]:
        raise ValueError(f"the traffic states {stated} edges with the self "
                         f"loops; its generator made {col_ind.shape[0]}")
    return GraphData(row_ptr, col_ind, p["n_feats"], p["n_classes"], sha,
                     seconds)


def port_graph(data: GraphData, dense, cache_dir: Path, log=print):
    """The port's ``Graph`` (CPU tensors, raw arrays kept) of ``data``'s
    CSR, by the port's own host build (``csr_to_csc_permute``,
    ``build_graph_from_csr``), cached by the port's ``graph/cache.py`` under
    the CSR's hash and the port's ``graph_key()``, as ``load_reddit`` keys
    its cache: a change to the planner's constants builds anew."""
    from dgnn_tpu_torch.data.reddit import graph_key
    from dgnn_tpu_torch.graph.build import csr_to_csc_permute
    from dgnn_tpu_torch.graph.cache import LAYOUT, load_graph, save_graph
    from dgnn_tpu_torch.graph.structure import build_graph_from_csr

    path = Path(cache_dir) / (f"port_{data.sha[:16]}_{dense}_{LAYOUT}_"
                              f"{graph_key()}.npz")
    t0 = time.perf_counter()
    if path.exists():
        graph = load_graph(str(path))
        stage = "port graph load"
    else:
        col_ptr, row_ind, permute = csr_to_csc_permute(data.row_ptr,
                                                       data.col_ind)
        graph = build_graph_from_csr(data.row_ptr, data.col_ind, col_ptr,
                                     row_ind, permute, dense=dense,
                                     edge_tables=False)
        data.seconds["port graph build"] = time.perf_counter() - t0
        log(f"setup stage port graph build: "
            f"{data.seconds['port graph build']:.3f} s")
        path.parent.mkdir(parents=True, exist_ok=True)
        save_graph(str(path), graph)
        stage = "port graph build + save"
    data.seconds[stage] = time.perf_counter() - t0
    log(f"setup stage {stage}: {data.seconds[stage]:.3f} s")
    return graph
