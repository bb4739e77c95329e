"""Masked neighbour max over dense per-cloud masks: CUDA kernel wrapper and
its plain version.

    out[b, i, f] = max_j (mask_neg[b, i, j] + h_src[b, j, f])

Port of the two tiled kernels of ``scripts/exp_r5_ec_tiles.py``
(``pallas_tiles``, one candidate column per inner step, and
``pallas_tiles2``, eight per step), which compute what
``dgnn_tpu/ops/edgeconv.py:_masked_max`` computes: the hot loop of
``edge_conv_max_dense`` and so of every DGCNN layer.  ``masked_max``
launches the kernels of csrc/ec_tiles.cu for CUDA tensors, in the schedule
asked for ("step1" or "step8"), and raises on anything they do not take;
``masked_max_plain`` is the plain PyTorch version, which the wrapper takes
only when the tensors lie on the CPU.

The mask is bfloat16 or float32 and is ADDED to h_src in float32, never
selected on: a row that admits no column gives about ``neg``, exactly what
the plain version gives.  ``with_index=True`` also returns the FIRST
maximal j (a running strictly-greater max), which
``edge_conv_max_dense(bwd_mode="argmax")`` saves.

On the card the function is bound by the bytes of mask, h_src and out, so
the kernels do not walk all P candidates of a row: a first pass over the
mask lists each row's LIVE candidates (``live_candidates`` states the rule,
which is exact for every float mask; on a k-NN mask the live candidates are
the admitted ones), and the max is taken over the lists.  A row with more
than ``LIVE_CAP`` live candidates is walked densely by the same kernel.
``live_counts`` runs the first pass alone.

``LAUNCHES`` counts kernel launches: the max kernel per schedule, and the
list pass (a plain int each, added to only where the kernel is launched).
"""

from __future__ import annotations

import torch

from . import _build
from .bins import _on_cpu, _ptr

__all__ = ["masked_max", "masked_max_plain", "live_candidates",
           "live_counts", "SCHEDULES", "LAUNCHES", "LIVE_CAP",
           "reset_launches"]

SCHEDULES = ("step1", "step8")
LAUNCHES = {"masked_max_step1": 0, "masked_max_step8": 0,
            "masked_max_live_lists": 0}
# Entries of one row's list of live candidates (csrc/ec_tiles.cu kCap).
LIVE_CAP = 256
# The plain version's [P, P, Fc] broadcast holds at most this many floats.
_PLAIN_ELEMS = 1 << 26


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(mask_neg, h_src):
    if mask_neg.dim() != 3 or h_src.dim() != 3:
        raise ValueError(f"masked_max: mask {tuple(mask_neg.shape)} and h_src "
                         f"{tuple(h_src.shape)} must be [B, P, P] and "
                         "[B, P, F]")
    B, P, F = h_src.shape
    if tuple(mask_neg.shape) != (B, P, P) or min(B, P, F) < 1:
        raise ValueError(f"masked_max: mask {tuple(mask_neg.shape)} does not "
                         f"fit h_src {tuple(h_src.shape)}")
    if mask_neg.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("masked_max: the mask must be bfloat16 or float32, "
                        f"got {mask_neg.dtype}")
    if h_src.dtype != torch.float32:
        raise TypeError(f"masked_max: h_src must be float32, got "
                        f"{h_src.dtype}")


def masked_max_plain(mask_neg, h_src, *, with_index: bool = False):
    """Plain PyTorch masked max; the outputs of ``masked_max`` (whose two
    schedules compute this one function).  Walks the clouds, and the feature
    columns of a cloud, so that the [P, P, Fc] broadcast stays under
    ``_PLAIN_ELEMS`` floats."""
    _check(mask_neg, h_src)
    B, P, F = h_src.shape
    fc = max(1, min(F, _PLAIN_ELEMS // (P * P)))
    out = torch.empty((B, P, F), device=h_src.device, dtype=torch.float32)
    idx = (torch.empty((B, P, F), device=h_src.device, dtype=torch.int32)
           if with_index else None)
    j = torch.arange(P, device=h_src.device, dtype=torch.int32)[None, :, None]
    for b in range(B):
        mk = mask_neg[b].to(torch.float32)[:, :, None]      # [Pi, Pj, 1]
        for f0 in range(0, F, fc):
            vals = mk + h_src[b, None, :, f0:f0 + fc]       # [Pi, Pj, Fc]
            m = vals.amax(dim=1)
            out[b, :, f0:f0 + fc] = m
            if with_index:
                # first winner: the least j whose candidate reaches the max
                first = torch.where(vals >= m[:, None, :], j, 1 << 20)
                idx[b, :, f0:f0 + fc] = first.amin(dim=1)
    return (out, idx) if with_index else out


def live_candidates(mask_neg, h_src):
    """bool [B, P, P]: the candidates j of row (b, i) that the max has to
    look at.  With ``M_i`` the row's largest mask value and ``lo``, ``hi``
    the least and largest value of ``h_src[b]``, candidate j is dropped
    when ``mask[i, j] + hi < M_i + lo`` (both sums rounded to float32).
    Float32 addition is monotone in each operand, so a dropped candidate is
    strictly below the candidate of ``M_i`` in every channel: it neither
    wins nor ties, and ``masked_max_plain`` over the live candidates alone
    gives the same values and first-winner indices.  Nothing is assumed of
    the mask's values; on a {0, neg} mask with ``|neg|`` far above
    ``|h_src|`` the live candidates are exactly the admitted ones."""
    _check(mask_neg, h_src)
    mk = mask_neg.to(torch.float32)
    lo = h_src.amin(dim=(1, 2))[:, None, None]
    hi = h_src.amax(dim=(1, 2))[:, None, None]
    return ~((mk + hi) < (mk.amax(dim=-1, keepdim=True) + lo))


def _live_lists(mask_neg, h_src):
    """The list pass on the card: (entries [B, P, LIVE_CAP, 2] int32, count
    [B, P] int32).  Row (b, i)'s first count entries are (j, bits of its
    float32 mask value) of its live candidates in ascending j; count -1
    marks a row with more than LIVE_CAP of them."""
    B, P, F = h_src.shape
    dev = h_src.device
    # the ranges of h_src by chunk: 32 (csrc/ec_tiles.cu kMaxChunks) a cloud
    part = torch.empty((B, 32, 2), device=dev, dtype=torch.float32)
    entries = torch.empty((B, P, LIVE_CAP, 2), device=dev, dtype=torch.int32)
    count = torch.empty((B, P), device=dev, dtype=torch.int32)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.dgnn_ec_live_lists(
        _ptr(mask_neg), int(mask_neg.dtype == torch.bfloat16), _ptr(h_src),
        B, P, F, LIVE_CAP, _ptr(part), _ptr(entries), _ptr(count), stream)
    if err:
        raise RuntimeError(f"masked_max list pass launch failed: CUDA error "
                           f"{err} (B={B}, P={P}, F={F})")
    LAUNCHES["masked_max_live_lists"] += 1
    return entries, count


def _check_card(mask_neg, h_src):
    if not (mask_neg.is_contiguous() and h_src.is_contiguous()):
        raise ValueError("masked_max: mask and h_src must be contiguous")


def live_counts(mask_neg, h_src):
    """int32 [B, P]: how many live candidates each row has, or -1 where they
    are more than ``LIVE_CAP`` and ``masked_max`` walks the row densely.
    On the card this is the kernels' list pass alone."""
    _check(mask_neg, h_src)
    if _on_cpu(mask_neg, h_src):
        n = live_candidates(mask_neg, h_src).sum(dim=-1, dtype=torch.int32)
        return torch.where(n > LIVE_CAP, -1, n).to(torch.int32)
    _check_card(mask_neg, h_src)
    return _live_lists(mask_neg, h_src)[1]


def masked_max(mask_neg, h_src, *, schedule: str = "step1",
               with_index: bool = False):
    """max over j of ``mask_neg[b, i, j] + h_src[b, j, f]``.

    Args:
      mask_neg: [B, P, P] bfloat16 or float32 additive mask (0 = admitted,
        a large negative number = not), as ``graph.knn.knn_mask_neg`` makes.
      h_src: [B, P, F] float32.
      schedule: "step1" walks one candidate column per inner step, "step8"
        holds eight mask values and eight h_src rows in registers per step.
      with_index: also return the first maximal j.
    Returns out [B, P, F] float32, or (out, index [B, P, F] int32).  Any B,
    P, F: the kernels check their own bounds, nothing is padded.  Both
    schedules walk the lists of live candidates that the list pass makes of
    this mask and h_src (``live_candidates``).
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                         f"{schedule!r}")
    _check(mask_neg, h_src)
    if _on_cpu(mask_neg, h_src):
        return masked_max_plain(mask_neg, h_src, with_index=with_index)
    _check_card(mask_neg, h_src)
    B, P, F = h_src.shape
    entries, count = _live_lists(mask_neg, h_src)
    out = torch.empty((B, P, F), device=h_src.device, dtype=torch.float32)
    idx = (torch.empty((B, P, F), device=h_src.device, dtype=torch.int32)
           if with_index else None)
    lib = _build.load()
    stream = torch.cuda.current_stream(h_src.device).cuda_stream
    err = lib.dgnn_ec_masked_max(
        _ptr(mask_neg), int(mask_neg.dtype == torch.bfloat16), _ptr(h_src),
        B, P, F, 8 if schedule == "step8" else 1, LIVE_CAP, _ptr(entries),
        _ptr(count), _ptr(out), _ptr(idx), stream)
    if err:
        raise RuntimeError(f"masked_max kernel launch failed: CUDA error "
                           f"{err} (B={B}, P={P}, F={F}, {schedule})")
    LAUNCHES["masked_max_" + schedule] += 1
    return (out, idx) if with_index else out
