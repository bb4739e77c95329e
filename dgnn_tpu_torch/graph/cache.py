"""Disk cache for preprocessed graphs (port of ``dgnn_tpu/graph/cache.py``).

Host-side preprocessing (sorting, binning, hub planning) is done once a
graph; caching the finished ``Graph`` as an .npz lets later runs skip it.
The file has the JAX package's ``_d6`` layout: per direction (``fwd``,
``bwd``) and bin ``i`` the arrays ``<dir>_nbr_i``, ``<dir>_edge_i`` (with
edge tables), ``<dir>_row_i`` and ``<dir>_count_i``; the combine table
(``<dir>_cmb``, ``<dir>_cmb_ov_rows``, ``<dir>_cmb_ov``); ``<dir>_epos``;
the hub block's ``<dir>_dense_{row_ids,col_ids,mask,rc,ct,first}``; the raw
``row_ptr``, ``col_ind``, ``col_ptr``, ``row_ind``, ``permute``; and the
widths and sizes as JSON in ``meta_json``.  The JAX package also writes the
block's half schedule (``<dir>_dense_{rc,ct,first,mt}_h``), a TPU layout
that the port does not build: ``save_graph`` leaves it out and
``load_graph`` ignores it.

``load_graph`` reads the bins, the block's arrays and the raw arrays, and
builds the port's own derived fields from them as ``from_binned`` builds
them for a fresh graph: the combine tables, ``epos``, the block's
``chunk_ptr``.  So it reads a file of either package.  Each package keeps
its own files (the port's have names of their own), because a cached
build and a fresh one can bin differently when the binning changes under
an unchanged name.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.profiling import span
from . import binning as _binning
from . import hub as _hub
from .structure import BinnedAdj, Graph, _t, from_binned

__all__ = ["save_graph", "load_graph", "LAYOUT"]

# The file layout's name: the JAX package's ``_d6`` (its cache files end so)
LAYOUT = "d6"
_DENSE_KEYS = ("row_ids", "col_ids", "mask", "rc", "ct", "first")


def _pack_binned(prefix: str, adj: BinnedAdj, store: dict, meta: dict):
    meta[prefix] = {"widths": list(adj.widths), "num_rows": adj.num_rows,
                    "num_edges": adj.num_edges}
    for i in range(adj.num_bins):
        store[f"{prefix}_nbr_{i}"] = adj.nbr[i].numpy()
        if adj.edge[i] is not None:
            store[f"{prefix}_edge_{i}"] = adj.edge[i].numpy()
        store[f"{prefix}_row_{i}"] = adj.row[i].numpy()
        store[f"{prefix}_count_{i}"] = adj.count[i].numpy()
    if adj.cmb is not None:
        store[f"{prefix}_cmb"] = adj.cmb.main.numpy()
        store[f"{prefix}_cmb_ov_rows"] = adj.cmb.ov_rows.numpy()
        store[f"{prefix}_cmb_ov"] = adj.cmb.ov.numpy()
    if adj.epos is not None:
        store[f"{prefix}_epos"] = adj.epos.numpy()
    if adj.dense is not None:
        for name in _DENSE_KEYS:
            store[f"{prefix}_dense_{name}"] = getattr(adj.dense, name).numpy()
        meta[prefix]["dense_num_rows"] = adj.dense.num_rows


def _unpack_binned(prefix: str, z, meta: dict) -> BinnedAdj:
    m = meta[prefix]
    nbins = len(m["widths"])
    with_edge = nbins > 0 and f"{prefix}_edge_0" in z.files
    binned = _binning.BinnedCSR(
        nbr=tuple(z[f"{prefix}_nbr_{i}"] for i in range(nbins)),
        edge=tuple(z[f"{prefix}_edge_{i}"] if with_edge else None
                   for i in range(nbins)),
        row=tuple(z[f"{prefix}_row_{i}"] for i in range(nbins)),
        count=tuple(z[f"{prefix}_count_{i}"] for i in range(nbins)),
        widths=tuple(m["widths"]),
        num_rows=m["num_rows"],
        num_edges=m["num_edges"])
    plan = None
    if f"{prefix}_dense_mask" in z.files:
        plan = _hub.DensePlan(
            **{name: z[f"{prefix}_dense_{name}"] for name in _DENSE_KEYS},
            num_rows=int(m["dense_num_rows"]))
    return from_binned(binned, with_cmb=f"{prefix}_cmb" in z.files,
                       with_edge=with_edge, dense=plan)


def save_graph(path: str, g: Graph) -> None:
    """Write ``g`` (on the CPU) to ``path``, atomically: an interrupted run
    leaves no partial file under that name."""
    with span("dgnn.graph.cache.save"):
        store = {}
        meta = {"num_nodes": g.num_nodes, "num_edges": g.num_edges}
        _pack_binned("fwd", g.fwd, store, meta)
        _pack_binned("bwd", g.bwd, store, meta)
        for name in ("row_ptr", "col_ind", "col_ptr", "row_ind", "permute"):
            store[name] = getattr(g, name).numpy()
        store["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8)
        tmp = path + ".tmp.npz"
        np.savez(tmp, **store)
        os.replace(tmp, path)


def load_graph(path: str) -> Graph:
    """The Graph (CPU tensors) that ``save_graph`` wrote to ``path``, or one
    that the JAX package's ``save_graph`` wrote."""
    with span("dgnn.graph.cache.load"), np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        return Graph(
            **{name: _t(z[name]) for name in ("row_ptr", "col_ind", "col_ptr",
                                              "row_ind", "permute")},
            fwd=_unpack_binned("fwd", z, meta),
            bwd=_unpack_binned("bwd", z, meta),
            num_nodes=meta["num_nodes"],
            num_edges=meta["num_edges"])
