"""Synthetic citation datasets and point clouds (numpy), a copy of
``dgnn_tpu/data/synthetic.py``.

Deterministic generators at each dataset's scale and statistics (node,
edge, feature and class counts, label homophily, power-law degrees for the
large graphs; ModelNet-style clouds of gaussian blobs).  The output is
identical, array for array, to the JAX package's for the same seed
(tests/test_torch_graph.py and tests/test_torch_edgeconv.py hold them
equal).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.profiling import span

__all__ = ["CitationData", "synthetic_citation", "synthetic_point_clouds",
           "rmat_edges", "CITATION_SHAPES", "structure_task_from_csr"]

# name: (num_nodes, num_edges(directed, pre-self-loop), n_feats, n_classes)
CITATION_SHAPES = {
    "cora": (2708, 10556, 1433, 7),
    "citeseer": (3327, 9228, 3703, 6),
    "pubmed": (19717, 88651, 500, 3),
    "reddit": (232965, 114615892, 602, 41),
}


@dataclasses.dataclass
class CitationData:
    src: np.ndarray
    dst: np.ndarray
    num_nodes: int
    features: np.ndarray  # [N, F] float32
    labels: np.ndarray  # [N] int32
    train_mask: np.ndarray  # [N] bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    n_classes: int


def rmat_edges(num_nodes: int, num_edges: int, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19) -> tuple:
    """R-MAT power-law edge generator (Graph500-style recursive quadrants),
    vectorized over all edges at once; undirected-ized by symmetrizing."""
    with span("dgnn.data.rmat"):
        rng = np.random.default_rng(seed)
        scale = int(np.ceil(np.log2(max(num_nodes, 2))))
        n_half = num_edges // 2 + 1
        src = np.zeros(n_half, dtype=np.int64)
        dst = np.zeros(n_half, dtype=np.int64)
        for _ in range(scale):
            r = rng.random(n_half)
            right = r >= a + b  # falls into lower quadrants (dst bit set)
            down = ((r >= a) & (r < a + b)) | (r >= a + b + c)  # src bit set
            src = (src << 1) | down.astype(np.int64)
            dst = (dst << 1) | right.astype(np.int64)
        src %= num_nodes
        dst %= num_nodes
        # permute node ids so hubs aren't clustered at low ids
        perm = rng.permutation(num_nodes)
        src, dst = perm[src], perm[dst]
        s = np.concatenate([src, dst])[:num_edges]
        d = np.concatenate([dst, src])[:num_edges]
        return s, d


def synthetic_citation(name: str = "cora", seed: int = 0,
                       homophily: float = 0.7) -> CitationData:
    """Citation-style node-classification task at the named dataset's scale.

    Labels come from random class assignment; edges are rewired so a
    `homophily` fraction connects same-class nodes; features are a noisy
    class signature, so a GNN can actually learn.
    """
    if name not in CITATION_SHAPES:
        raise ValueError(f"Unknown dataset: {name} "
                         f"(known: {sorted(CITATION_SHAPES)})")
    n, e, f, c = CITATION_SHAPES[name]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, n).astype(np.int32)

    if name == "reddit":
        src, dst = rmat_edges(n, e, seed=seed)
    else:
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
    # homophilous rewiring: for a fraction of edges, resample dst from the
    # same class as src (vectorized via per-class node pools)
    order = np.argsort(labels, kind="stable")
    class_start = np.searchsorted(labels[order], np.arange(c))
    class_count = np.bincount(labels, minlength=c)
    rewire = rng.random(len(src)) < homophily
    cls = labels[src[rewire]]
    offs = (rng.random(rewire.sum()) * class_count[cls]).astype(np.int64)
    dst = dst.copy()
    dst[rewire] = order[class_start[cls] + offs]

    # features: class centroid (sparse-ish signature) + noise
    centroids = (rng.random((c, f)) < 0.05).astype(np.float32)
    feats = centroids[labels] + rng.normal(0, 0.5, (n, f)).astype(np.float32)

    idx = rng.permutation(n)
    n_train = max(20 * c, n // 10)
    n_val = max(500, n // 20)
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[idx[:n_train]] = True
    val_mask[idx[n_train:n_train + n_val]] = True
    test_mask[idx[n_train + n_val:]] = True
    return CitationData(src=src, dst=dst, num_nodes=n, features=feats,
                        labels=labels, train_mask=train_mask, val_mask=val_mask,
                        test_mask=test_mask, n_classes=c)


def structure_task_from_csr(row_ptr, col_ind, n_classes: int, n_feats: int,
                            seed: int = 0, rounds: int = 8):
    """Node-classification task derived from an existing graph's edges.

    Labels are a multi-source BFS Voronoi partition: ``n_classes`` random
    seed nodes each claim the nodes closest to them (ties to the lower class
    id), giving connected, homophilous label regions over the actual edge
    set, so accuracy on the graph means something.  Each BFS round packs
    (dist, label) into one int64 key and takes a per-row
    ``np.minimum.reduceat`` over the CSR segments.  Same seed, same arrays
    as ``dgnn_tpu/data/synthetic.py:structure_task_from_csr``.

    Returns (features [N, F] f32, labels [N] i32, train/val/test masks).
    """
    row_ptr = np.asarray(row_ptr, np.int64)
    col_ind = np.asarray(col_ind, np.int64)
    n = len(row_ptr) - 1
    rng = np.random.default_rng(seed)
    c = n_classes

    if len(col_ind) == 0:
        # zero-edge graph: the reduceat below would index col_ind[-1]; BFS
        # means nothing, so random labels, centroid features as usual
        labels = rng.integers(0, c, n).astype(np.int32)
        return _finish_structure_task(rng, labels, n, c, n_feats)

    seeds = rng.choice(n, size=c, replace=False)
    big = np.int64(n + 1)  # "unreached" distance sentinel
    dist = np.full(n, big, np.int64)
    lab = np.zeros(n, np.int64)
    dist[seeds] = 0
    lab[seeds] = np.arange(c)
    nonempty = row_ptr[:-1] < row_ptr[1:]
    for _ in range(rounds):
        key = dist * c + lab  # lexicographic (dist, label) in one int64
        nk = np.minimum.reduceat(key[col_ind], np.minimum(
            row_ptr[:-1], len(col_ind) - 1))
        cand_dist = nk // c + 1
        upd = nonempty & (cand_dist < dist)
        if not upd.any():
            break
        dist[upd] = cand_dist[upd]
        lab[upd] = nk[upd] % c
    # unreached nodes (isolated / tiny components): random labels
    unreached = dist >= big
    lab[unreached] = rng.integers(0, c, int(unreached.sum()))
    labels = lab.astype(np.int32)
    return _finish_structure_task(rng, labels, n, c, n_feats)


def _finish_structure_task(rng, labels, n, c, n_feats):
    centroids = (rng.random((c, n_feats)) < 0.05).astype(np.float32)
    feats = centroids[labels] + rng.normal(
        0, 0.5, (n, n_feats)).astype(np.float32)

    idx = rng.permutation(n)
    # clamp the train/val splits so a nonzero test split always remains
    # (tiny n would otherwise make test accuracy a 0/0)
    n_train = min(max(20 * c, n // 10), max(1, int(n * 0.6)))
    n_val = min(max(500, n // 20), max(1, int(n * 0.2)))
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[idx[:n_train]] = True
    val_mask[idx[n_train:n_train + n_val]] = True
    test_mask[idx[n_train + n_val:]] = True
    return feats, labels, train_mask, val_mask, test_mask


def synthetic_point_clouds(num_samples: int, num_points: int = 1024,
                           num_classes: int = 40, seed: int = 0,
                           template_seed: int | None = None):
    """ModelNet-style point clouds: each class is a random gaussian-blob shape
    template; samples are rotated/jittered instances.  Returns (x [S,P,3]
    float32, y [S] int32).  Same seeds, same arrays as
    ``dgnn_tpu/data/synthetic.py:synthetic_point_clouds``.

    ``template_seed`` fixes the class shapes independently of ``seed`` so a
    train and a test split (different ``seed``) share the SAME classes."""
    trng = np.random.default_rng(seed if template_seed is None
                                 else template_seed)
    rng = np.random.default_rng(seed)
    templates = []
    for _ in range(num_classes):
        k = trng.integers(3, 8)
        centers = trng.normal(0, 1, (k, 3))
        scales = trng.uniform(0.1, 0.4, (k, 1))
        templates.append((centers, scales))
    y = rng.integers(0, num_classes, num_samples).astype(np.int32)
    x = np.zeros((num_samples, num_points, 3), np.float32)
    for i in range(num_samples):
        centers, scales = templates[y[i]]
        comp = rng.integers(0, len(centers), num_points)
        pts = centers[comp] + rng.normal(0, 1, (num_points, 3)) * scales[comp]
        theta = rng.uniform(0, 2 * np.pi)
        rot = np.array([[np.cos(theta), -np.sin(theta), 0],
                        [np.sin(theta), np.cos(theta), 0], [0, 0, 1]])
        x[i] = (pts @ rot.T).astype(np.float32)
    return x, y
