"""Fused EdgeConv: per-channel neighbour max (port of
``dgnn_tpu/ops/edgeconv.py``).

    out[i, f] = max_j (h_dst[i, f] + h_src[nbr[i, j], f])

``edge_conv_max_dense`` is the path the DGCNN model takes: point clouds make
the k-NN graph block-diagonal with small blocks, so the neighbour max is
taken densely per cloud under an additive mask (graph/knn.py
``knn_mask_neg``) by the hand-written kernel of ops/ec_tiles.py, in its
"step8" schedule.  Its backward:

- ``bwd_mode="tie_sum"`` (the default, as in the JAX op) sums g over every
  source whose candidate equals the saved max: ``tie_sum_bwd``, the
  hand-written kernels of csrc/ec_ties.cu for CUDA tensors (a list pass
  that reads the mask once and lists, per source column, the rows that
  pass the filter below, then the sum over those lists from (m, g) slabs
  staged in shared memory; no host sync, no allocation whose size depends
  on the data, a fixed summation order), and its plain version
  ``_dsrc_ties`` for CPU tensors; the list pass's plain version is
  ``tie_lists_plain``.  The JAX counterpart
  (``_ecd_dsrc_ties``) is an XLA pass that broadcasts a [B, Pj, Pi, Fc]
  indicator, which no card holds at ModelNet width.  ``_dsrc_ties`` walks
  only the (i, j) pairs that can tie (``torch.nonzero`` of a filter), in
  slices whose [pairs, F] float32 intermediates stay under ``PAIR_BYTES``
  each, recomputes ``h_src[j] + mask[i, j]`` with the float32 add the
  forward used, and ``index_add_``s g to every source whose candidate
  equals the saved max.  The filter keeps every pair that can hit, for any
  float mask: rounded addition is monotone, so a hit in feature f needs
  fl(mask[i, j] + max_f h_src[j]) >= m[i, f] >= min_f m[i].  On the
  model's k-NN masks it keeps about the admitted pairs.  The kernel tests
  the same filter and the same equality, so its hits are the plain
  version's bit for bit.
- ``bwd_mode="argmax"`` scatters g to the saved first-winner index with one
  ``scatter_add_`` over [B, P, F].

``mul_dtype`` follows the JAX op: bfloat16 (the default) rounds g to
bfloat16, sums in float32 and rounds the sum once; float32 is exact.

``LAUNCHES`` counts ``tie_sum_bwd``'s launches (plain ints, added to only
where a kernel is launched): ``tie_sum_lists`` the list pass (its bounds
and list kernels), ``tie_sum_bwd`` the sum.

``edge_conv_max`` is the gather path over an explicit [N, k] neighbour
table, in torch ops in both directions (the JAX package has no kernel for
it either).
"""

from __future__ import annotations

import torch

from . import _build
from .bins import _on_cpu, _ptr
from .ec_tiles import masked_max

__all__ = ["edge_conv_max", "edge_conv_max_dense", "tie_sum_bwd",
           "tie_lists_plain", "MUL_DTYPES", "BWD_MODES", "PAIR_BYTES",
           "TIE_CAP", "LAUNCHES", "reset_launches"]

MUL_DTYPES = (torch.bfloat16, torch.float32)
BWD_MODES = ("tie_sum", "argmax")
# Each [pairs, F] float32 intermediate of the tie_sum backward, and each
# [rows, k, F] one of the gather path, holds at most this many bytes; about
# five are alive at once.
PAIR_BYTES = 256 << 20
# The masked-max kernel's schedule on the model's path (ops/ec_tiles.py):
# eight candidates a step, the faster of the two at DGCNN's widths.
SCHEDULE = "step8"
# Entries of a source column's list in the tie-sum list pass (the kernels'
# kCap): the DGCNN model's k-NN masks in feature space pass well over 128
# rows in some columns, and under 256; a column with more is walked
# densely by the sum.
TIE_CAP = 256
LAUNCHES = {"tie_sum_bwd": 0, "tie_sum_lists": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round(t: torch.Tensor, mul_dtype: torch.dtype) -> torch.Tensor:
    if mul_dtype == torch.float32:
        return t
    return t.to(mul_dtype).to(torch.float32)


def _dsrc_argmax(kstar, g, mul_dtype):
    """d_src[b, j, f] = sum_i g[b, i, f] [kstar[b, i, f] == j]."""
    d_src = torch.zeros_like(g)
    d_src.scatter_add_(1, kstar.long(), _round(g, mul_dtype))
    return _round(d_src, mul_dtype)


def _tie_candidates(m, mask_neg, h_src):
    """[B, P (i), P (j)] bool: the pairs (i, j) that can tie,
    fl(mask[i, j] + hmax[j]) >= mmin[i], with hmax[j] the max of h_src[j]
    over f and mmin[i] the min of m[i] over f."""
    B, P, _ = h_src.shape
    hmax = h_src.amax(dim=-1)                              # [B, P] over j
    mmin = m.amin(dim=-1)                                  # [B, P] over i
    # the sum in float32 as the forward's (a bfloat16 mask is promoted),
    # in batch slices whose float32 sums stay under PAIR_BYTES
    cand = torch.empty(mask_neg.shape, dtype=torch.bool,
                       device=mask_neg.device)
    bstep = max(1, PAIR_BYTES // (4 * P * P))
    for s in range(0, B, bstep):
        torch.ge(mask_neg[s:s + bstep] + hmax[s:s + bstep, None, :],
                 mmin[s:s + bstep, :, None], out=cand[s:s + bstep])
    return cand


def _dsrc_ties(m, mask_neg, h_src, g, mul_dtype):
    """d_src[b, j, f] = sum_i g[b, i, f]
                        [h_src[b, j, f] + mask[b, i, j] == m[b, i, f]]
    over the pairs that can satisfy it, for any float mask.

    A pair (i, j) hits in feature f only if fl(mask[i, j] + h_src[j, f])
    == m[i, f]; rounded addition is monotone in each operand, so then
    fl(mask[i, j] + hmax[j]) >= m[i, f] >= mmin[i], with hmax[j] the max
    of h_src[j] over f and mmin[i] the min of m[i] over f.  The pairs that
    pass that test (``_tie_candidates``) are a superset of the hits, with
    no margin: on a {0, neg} mask with neg far below the activations they
    are the admitted pairs (and every pair of a row that admits nothing,
    whose max is about neg)."""
    B, P, F = h_src.shape
    b, i, j = torch.nonzero(_tie_candidates(m, mask_neg, h_src),
                            as_tuple=True)
    mval = mask_neg[b, i, j].to(torch.float32)
    dst = b * P + i
    src = b * P + j
    hs = h_src.reshape(B * P, F)
    mm = m.reshape(B * P, F)
    gq = _round(g, mul_dtype).reshape(B * P, F)
    d_src = torch.zeros_like(hs)
    step = max(1, PAIR_BYTES // (4 * F))
    for s in range(0, dst.shape[0], step):
        d, sr = dst[s:s + step], src[s:s + step]
        hit = (hs[sr] + mval[s:s + step, None]) == mm[d]
        d_src.index_add_(0, sr, torch.where(hit, gq[d], 0.0))
    return _round(d_src, mul_dtype).reshape(B, P, F)


def tie_lists_plain(m, mask_neg, h_src, cap: int = TIE_CAP):
    """The tie-sum list pass's plain version: for each source column j of
    each cloud, the rows i that pass ``_dsrc_ties``'s filter, in ascending
    order, with their mask values.

    Returns (entries [B, P, cap, 2] int32: entries[b, j, t] is (i, the
    float32 bits of mask[b, i, j]) for the t-th row of column j's list,
    for the first ``cap`` rows, zeros after them; count [B, P] int32: how
    many rows pass, more than ``cap`` where the list is incomplete).  The
    kernel leaves the slots past a column's count as they fall."""
    B, P, _ = h_src.shape
    col = _tie_candidates(m, mask_neg, h_src).transpose(1, 2)   # [B, j, i]
    count = col.sum(dim=-1, dtype=torch.int32)
    rank = col.cumsum(dim=-1, dtype=torch.int64) - 1
    b, j, i = torch.nonzero(col & (rank < cap), as_tuple=True)
    slot = rank[b, j, i]
    entries = torch.zeros((B, P, cap, 2), dtype=torch.int32,
                          device=h_src.device)
    entries[b, j, slot, 0] = i.to(torch.int32)
    entries[b, j, slot, 1] = mask_neg[b, i, j].to(torch.float32).view(
        torch.int32)
    return entries, count


def _tie_lists(m, mask_neg, h_src):
    """The list pass on the card: (bounds [2, B, P]: hmax over j, then
    mmin over i; entries [B, P, TIE_CAP, 2] int32; count [B, P] int32),
    in ``tie_lists_plain``'s format."""
    B, P, F = h_src.shape
    dev = h_src.device
    bounds = torch.empty((2, B, P), device=dev, dtype=torch.float32)
    entries = torch.empty((B, P, TIE_CAP, 2), device=dev, dtype=torch.int32)
    count = torch.empty((B, P), device=dev, dtype=torch.int32)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.dgnn_ec_tie_lists(
        _ptr(mask_neg), int(mask_neg.dtype == torch.bfloat16), _ptr(h_src),
        _ptr(m), B, P, F, TIE_CAP, _ptr(bounds), _ptr(entries), _ptr(count),
        stream)
    if err:
        raise RuntimeError(f"tie_sum_bwd list pass launch failed: CUDA "
                           f"error {err} (B={B}, P={P}, F={F})")
    LAUNCHES["tie_sum_lists"] += 1
    return bounds, entries, count


def tie_sum_bwd(m, mask_neg, h_src, g, mul_dtype=torch.bfloat16):
    """d_src[b, j, f] = sum_i gq[b, i, f]
                        [fl32(h_src[b, j, f] + mask[b, i, j]) == m[b, i, f]]
    (gq: g rounded to ``mul_dtype``; the sum in float32, rounded once to
    ``mul_dtype``): the tie-sum backward of ``edge_conv_max_dense``.

    For CUDA tensors the kernels of csrc/ec_ties.cu (the list pass, then
    the sum over its lists), which raise on what they do not take; for CPU
    tensors the plain version ``_dsrc_ties``.

    Args:
      m: [B, P, F] float32, the forward's max (``masked_max``).
      mask_neg: [B, P, P] bfloat16 or float32, the forward's mask.
      h_src, g: [B, P, F] float32.
    Returns d_src [B, P, F] float32."""
    if mul_dtype not in MUL_DTYPES:
        raise ValueError(f"mul_dtype must be one of {MUL_DTYPES}, got "
                         f"{mul_dtype}")
    B, P, F = h_src.shape
    if (tuple(m.shape) != (B, P, F) or tuple(g.shape) != (B, P, F)
            or tuple(mask_neg.shape) != (B, P, P)):
        raise ValueError(f"tie_sum_bwd: m {tuple(m.shape)}, mask "
                         f"{tuple(mask_neg.shape)}, h_src {(B, P, F)} and g "
                         f"{tuple(g.shape)} do not fit")
    if mask_neg.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("tie_sum_bwd: the mask must be bfloat16 or float32, "
                        f"got {mask_neg.dtype}")
    if {m.dtype, h_src.dtype, g.dtype} != {torch.float32}:
        raise TypeError("tie_sum_bwd: m, h_src and g must be float32")
    if _on_cpu(m, mask_neg, h_src, g):
        return _dsrc_ties(m, mask_neg, h_src, g, mul_dtype)
    if not all(t.is_contiguous() for t in (m, mask_neg, h_src, g)):
        raise ValueError("tie_sum_bwd: m, mask, h_src and g must be "
                         "contiguous")
    bounds, entries, count = _tie_lists(m, mask_neg, h_src)
    d_src = torch.empty_like(h_src)
    lib = _build.load()
    stream = torch.cuda.current_stream(h_src.device).cuda_stream
    err = lib.dgnn_ec_tie_sum(
        _ptr(mask_neg), int(mask_neg.dtype == torch.bfloat16), _ptr(m),
        _ptr(h_src), _ptr(g), _ptr(bounds), _ptr(entries), _ptr(count), B,
        P, F, TIE_CAP, int(mul_dtype == torch.bfloat16), _ptr(d_src), stream)
    if err:
        raise RuntimeError(f"tie_sum_bwd kernel launch failed: CUDA error "
                           f"{err} (B={B}, P={P}, F={F})")
    LAUNCHES["tie_sum_bwd"] += 1
    return d_src


class _EdgeConvMaxDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mask_neg, h_src, h_dst, mul_dtype, bwd_mode):
        ctx.mul_dtype = mul_dtype
        ctx.bwd_mode = bwd_mode
        if bwd_mode == "argmax":
            m, kstar = masked_max(mask_neg, h_src, schedule=SCHEDULE,
                                  with_index=True)
            ctx.save_for_backward(kstar)
        else:
            # save only the max VALUE: the forward stays a plain max and the
            # backward matches sources by exact value equality
            m = masked_max(mask_neg, h_src, schedule=SCHEDULE)
            ctx.save_for_backward(m, mask_neg, h_src)
        return h_dst + m

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.bwd_mode == "argmax":
            (kstar,) = ctx.saved_tensors
            d_src = _dsrc_argmax(kstar, g, ctx.mul_dtype)
        else:
            m, mask_neg, h_src = ctx.saved_tensors
            d_src = tie_sum_bwd(m, mask_neg, h_src, g, ctx.mul_dtype)
        # d/d h_dst is the identity (h_dst[i, f] is in every candidate); the
        # mask is not differentiated
        return None, d_src, g, None, None


def edge_conv_max_dense(mask_neg, h_src, h_dst,
                        mul_dtype: torch.dtype = torch.bfloat16,
                        bwd_mode: str = "tie_sum"):
    """out[b, i, f] = max over the j that ``mask_neg[b, i]`` admits of
    (h_dst[b, i, f] + h_src[b, j, f]).

    Args:
      mask_neg: [B, P, P] bfloat16 / float32 additive mask (0 = edge, a
        large negative number = no edge), from graph/knn.py knn_mask_neg.
      h_src, h_dst: [B, P, F] float32.
      mul_dtype: torch.bfloat16 (default) or torch.float32 (exact
        gradients), see the module docstring.
      bwd_mode: "tie_sum" (default) saves only the max value and sums the
        gradient over every exactly tied source; "argmax" saves the
        first-winner index and gives it the whole gradient.
    Returns [B, P, F].
    """
    if mul_dtype not in MUL_DTYPES:
        raise ValueError(f"mul_dtype must be one of {MUL_DTYPES}, got "
                         f"{mul_dtype}")
    if bwd_mode not in BWD_MODES:
        raise ValueError(f"bwd_mode must be one of {BWD_MODES}, got "
                         f"{bwd_mode!r}")
    return _EdgeConvMaxDense.apply(mask_neg, h_src, h_dst, mul_dtype,
                                   bwd_mode)


def _gather_max(nbr, h_src, h_dst):
    """(out [N, F], kstar [N, F] int64: the first maximal slot), in row
    chunks whose [rows, k, F] candidates stay under PAIR_BYTES."""
    n, k = nbr.shape
    F = h_src.shape[-1]
    out = torch.empty((n, F), device=h_src.device, dtype=h_src.dtype)
    kstar = torch.empty((n, F), device=h_src.device, dtype=torch.int64)
    slot = torch.arange(k, device=h_src.device)[None, :, None]
    step = max(1, PAIR_BYTES // (4 * k * F))
    for s in range(0, n, step):
        vals = h_dst[s:s + step, None, :] + h_src[nbr[s:s + step].long()]
        m = vals.amax(dim=1)
        out[s:s + step] = m
        kstar[s:s + step] = torch.where(vals >= m[:, None, :], slot,
                                        k).amin(dim=1)
    return out, kstar


class _EdgeConvMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nbr, h_src, h_dst):
        out, kstar = _gather_max(nbr, h_src, h_dst)
        # residual: the winning source id per (node, channel)
        ctx.save_for_backward(torch.gather(nbr.long(), 1, kstar))
        ctx.num_src = h_src.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        (node_star,) = ctx.saved_tensors
        n, F = g.shape
        cols = torch.arange(F, device=g.device)
        d_src = torch.zeros(ctx.num_src * F, device=g.device, dtype=g.dtype)
        d_src.index_add_(0, (node_star * F + cols).reshape(-1),
                         g.reshape(-1))
        return None, d_src.reshape(ctx.num_src, F), g


def edge_conv_max(nbr, h_src, h_dst):
    """out[i, f] = max over j in nbr[i] of (h_dst[i, f] + h_src[j, f]).

    Args:
      nbr: [N, k] int32 neighbour ids (a k-NN list; typically includes i).
      h_src: [M, F] source-side features; h_dst: [N, F] destination-side.
    The gradient of h_src goes to the first maximal neighbour slot.
    """
    return _EdgeConvMax.apply(nbr, h_src, h_dst)
