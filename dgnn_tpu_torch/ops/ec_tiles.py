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

``LAUNCHES`` counts kernel launches per schedule (a plain int each, added
to only where the kernel is launched).
"""

from __future__ import annotations

import torch

from . import _build
from .bins import _on_cpu, _ptr

__all__ = ["masked_max", "masked_max_plain", "SCHEDULES", "LAUNCHES",
           "reset_launches"]

SCHEDULES = ("step1", "step8")
LAUNCHES = {"masked_max_step1": 0, "masked_max_step8": 0}
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
    P, F: the kernels check their own bounds, nothing is padded.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                         f"{schedule!r}")
    _check(mask_neg, h_src)
    if _on_cpu(mask_neg, h_src):
        return masked_max_plain(mask_neg, h_src, with_index=with_index)
    if not (mask_neg.is_contiguous() and h_src.is_contiguous()):
        raise ValueError("masked_max: mask and h_src must be contiguous")
    B, P, F = h_src.shape
    out = torch.empty((B, P, F), device=h_src.device, dtype=torch.float32)
    idx = (torch.empty((B, P, F), device=h_src.device, dtype=torch.int32)
           if with_index else None)
    lib = _build.load()
    stream = torch.cuda.current_stream(h_src.device).cuda_stream
    err = lib.dgnn_ec_masked_max(
        _ptr(mask_neg), int(mask_neg.dtype == torch.bfloat16), _ptr(h_src),
        B, P, F, 8 if schedule == "step8" else 1, _ptr(out), _ptr(idx),
        stream)
    if err:
        raise RuntimeError(f"masked_max kernel launch failed: CUDA error "
                           f"{err} (B={B}, P={P}, F={F}, {schedule})")
    LAUNCHES["masked_max_" + schedule] += 1
    return (out, idx) if with_index else out
