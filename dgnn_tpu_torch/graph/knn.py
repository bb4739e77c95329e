"""Batched k-NN graph construction on the device (port of
``dgnn_tpu/graph/knn.py``).

Pairwise squared distances come from one batched matrix product
(``torch.matmul``, as the JAX package leaves it to XLA); the rest is
elementwise passes and reductions over the [B, P, P] distance matrix.
Nothing here is differentiated: callers build the graph under
``torch.no_grad()``.

The arithmetic keeps the JAX function's order (``sq[:, None, :] - 2 *
inner``, a bfloat16 copy of d2 for the counting passes, the bfloat16 cast
of the bisection's ``mid`` and ``hi``, the one-ulp widening before the
float32 refinement), so that the same features give the same mask.  A
float32 matrix product that runs in TF32 would not: keep
``torch.backends.cuda.matmul.allow_tf32`` off (PyTorch's default).
"""

from __future__ import annotations

import torch

__all__ = ["knn_graph", "knn_mask_neg"]


def _half_d2(x: torch.Tensor) -> torch.Tensor:
    """d2[b, i, j] = |xj|^2 - 2 xi.xj: the squared distance without the
    row-constant |xi|^2, which no row-wise ranking needs."""
    sq = (x * x).sum(dim=-1)                       # [B, P]
    inner = torch.matmul(x, x.transpose(1, 2))     # [B, P, P]
    return sq[:, None, :] - 2.0 * inner


def knn_graph(x: torch.Tensor, k: int) -> torch.Tensor:
    """k nearest neighbours (by squared euclidean distance, self included).

    Args:
      x: [B, P, D] batched point features.
      k: neighbours per point (k <= P).
    Returns:
      [B * P, k] int32 global neighbour ids into the flattened [B * P] point
      set (block-diagonal batching).
    """
    b, p, _ = x.shape
    d2 = _half_d2(x)
    idx = torch.topk(-d2, k, dim=-1).indices       # [B, P, k]
    offs = (torch.arange(b, device=x.device, dtype=torch.int32) * p)
    return (idx.to(torch.int32) + offs[:, None, None]).reshape(b * p, k)


def knn_mask_neg(x: torch.Tensor, k: int, *, neg: float = -1e30,
                 exact: bool = False, bisect_iters: int = 12,
                 refine_iters: int = 0,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dense k-NN adjacency as an additive max-mask.

    Returns [B, P, P] ``dtype`` (bfloat16 by default: the mask is {0, neg})
    with 0 where j is among i's k nearest neighbours (self included) and
    ``neg`` elsewhere, so that neighbour-max aggregation is a dense
    ``max_j (vals + mask)`` (ops/ec_tiles.py).

    The per-row k-th-distance threshold is found by value bisection:
    ``bisect_iters`` counting passes over a bfloat16 copy of d2 narrow the
    interval, then ``refine_iters`` float32 passes tighten it.  Membership
    is by threshold, so a row can admit slightly MORE than k neighbours
    (points inside the remaining interval, bfloat16 tie groups, exact
    ties), never fewer.  ``exact=True`` takes the k-th distance from
    ``torch.topk`` instead.
    """
    d2 = _half_d2(x)
    zero = torch.zeros((), device=x.device, dtype=dtype)
    negv = torch.full((), neg, device=x.device, dtype=dtype)
    if exact:
        kth = torch.topk(-d2, k, dim=-1).values    # negated, descending
        thresh = -kth[..., -1]                     # k-th smallest distance
        return torch.where(d2 <= thresh[..., None], zero, negv)
    d2b = d2.to(torch.bfloat16)
    lo = d2.amin(dim=-1)                           # <= the k-th distance
    hi = d2.amax(dim=-1)                           # >= the k-th distance

    def bisect(table, lo, hi, iters, cast):
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            cnt = (table <= cast(mid)[..., None]).sum(dim=-1)
            small = cnt < k
            lo, hi = torch.where(small, mid, lo), torch.where(small, hi, mid)
        return lo, hi

    # the bfloat16 threshold stays a SUPERSET bound (monotonic rounding)
    lo, hi = bisect(d2b, lo, hi, bisect_iters,
                    lambda t: t.to(torch.bfloat16))
    if refine_iters == 0:
        # bfloat16 throughout: membership on the rounded copy too
        return torch.where(d2b <= hi.to(torch.bfloat16)[..., None], zero,
                           negv)
    # widen by one bfloat16 ulp before refining in float32: the
    # bfloat16-counted hi can sit one rounding step below the true k-th
    # distance, and the float32 bisection keeps count(d2 <= hi) >= k only
    # if it starts true
    ulp = hi.abs() * 2.0 ** -7 + 1e-12
    lo, hi = bisect(d2, lo - ulp, hi + ulp, refine_iters, lambda t: t)
    return torch.where(d2 <= hi[..., None], zero, negv)
