"""Two neighbour-gather strategies as CUDA kernels, with their plain
versions (port of the two Pallas kernels of ``scripts/microbench_gather.py``).

``gather_rows_sum`` (``bench_dma_gather``), a sum of the table rows each
segment names:

    out[s, :] = sum_j feat[nbr[s, j], :]

Its bound is bytes: the distinct rows named, the ids and the output, once
each.  The kernel walks the table one column slice of 32 floats (a 128-byte
line of every row) at a time, all warps in flight on the same slice, so
each line of a row comes from device memory about once and the ids'
repeats of it are L2 hits; past that it is bound by the L2's rate for
these gathers.  Column slices, not row ranges: the output is written once
and the ids are read once a slice, where a row range would write every
output row again.  Wider slices were slower on every table measured
(scripts/gather_variants_torch.py).

``gather_lanes`` (``bench_vmem_dynamic_gather``): a per-lane gather from a
table held in shared memory, one column slab per 1024-thread block (32
lanes that each name their own table row are one shared-memory access, but
32 cache lines for a read of the table where it lies in L2):

    out[r, q] = tab[idx[r, q % L], q]        (L = idx.shape[1])

Both launch the kernels of csrc/gather.cu for CUDA tensors and raise on
anything those do not take; the ``*_plain`` versions run for CPU tensors
only.  No model of the package calls them: scripts/microbench_gather_torch.py
is their path.  An id outside the table raises an IndexError in the plain
versions; on the card such an id traps (``gather_rows_sum``: in a checking
pass over the ids before the gather; ``gather_lanes``: where the id is
loaded, and row 0 of the slab is read in its place): the launch fails with
a CUDA error at the next synchronisation, and nothing outside the table is
read.

``LAUNCHES`` counts kernel launches per wrapper (a plain int each, added to
only where the kernel is launched).
"""

from __future__ import annotations

import torch

from . import _build
from .bins import _check_cuda, _on_cpu, _ptr

__all__ = ["gather_rows_sum", "gather_rows_sum_plain", "gather_lanes",
           "gather_lanes_plain", "lane_slab_width", "LAUNCHES",
           "reset_launches", "LANE_SLAB_BYTES"]

LAUNCHES = {"gather_rows_sum": 0, "gather_lanes": 0}
# Shared memory one block of gather_lanes gives its table slab
# (csrc/gather.cu kLaneSlabBytes).
LANE_SLAB_BYTES = 200 * 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _rows_shapes(feat, nbr):
    if feat.dim() < 2 or nbr.dim() != 2:
        raise ValueError(f"gather_rows_sum: feat {tuple(feat.shape)} must be "
                         f"[N, ...] and nbr {tuple(nbr.shape)} [S, W]")
    row = feat[0].numel() if feat.shape[0] else 0
    if feat.shape[0] < 1 or row < 1 or nbr.shape[1] < 1:
        raise ValueError(f"gather_rows_sum: empty feat {tuple(feat.shape)} "
                         f"or nbr {tuple(nbr.shape)}")
    return row


def gather_rows_sum_plain(feat, nbr):
    """Plain PyTorch ``gather_rows_sum``: same arguments and output."""
    _rows_shapes(feat, nbr)
    return feat[nbr.long()].sum(dim=1)


def gather_rows_sum(feat, nbr):
    """out[s] = sum over j of feat[nbr[s, j]].

    Args:
      feat: [N, ...] float32 table; a row (everything behind the first
        axis) must be a multiple of 4 floats for the kernel.
      nbr: [S, W] int32 row ids in [0, N).
    Returns [S, ...] float32.
    """
    row = _rows_shapes(feat, nbr)
    if _on_cpu(feat, nbr):
        return gather_rows_sum_plain(feat, nbr)
    if row % 4:
        raise ValueError(f"gather_rows_sum: a row of {row} floats; the "
                         "kernel copies 16-byte groups, so a row must be a "
                         "multiple of 4 floats")
    _check_cuda("gather_rows_sum", dict(feat=feat), dict(nbr=nbr))
    if feat.data_ptr() % 16:
        raise ValueError("gather_rows_sum: feat must be 16-byte aligned")
    S, W = nbr.shape
    out = torch.empty((S,) + tuple(feat.shape[1:]), device=feat.device,
                      dtype=torch.float32)
    lib = _build.load()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = lib.dgnn_gather_rows_sum(_ptr(feat), _ptr(nbr), feat.shape[0], S, W,
                                   row, _ptr(out), stream)
    if err:
        raise RuntimeError(f"gather_rows_sum kernel launch failed: CUDA "
                           f"error {err} (S={S}, W={W}, row={row})")
    LAUNCHES["gather_rows_sum"] += 1
    return out


def lane_slab_width(c: int, width: int) -> int:
    """Columns of the table one block keeps in shared memory: the largest
    power of two, at most 32 (a warp's lanes then read distinct banks) and
    under twice ``width``, whose [c, w] float32 slab fits
    ``LANE_SLAB_BYTES``; 0 if not even one column does.  ``width`` need not
    be a multiple of it: the last slab may overhang the table."""
    w = 32
    while w and (c * w * 4 > LANE_SLAB_BYTES or w >= 2 * width):
        w //= 2
    return w


def _lanes_shapes(tab, idx):
    if tab.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"gather_lanes: tab {tuple(tab.shape)} and idx "
                         f"{tuple(idx.shape)} must be 2-D")
    c, width = tab.shape
    L = idx.shape[1]
    if c < 1 or L < 1 or width % L:
        raise ValueError(f"gather_lanes: the table's width {width} must be "
                         f"a multiple of idx's {L} lanes")


def gather_lanes_plain(tab, idx):
    """Plain PyTorch ``gather_lanes``: same arguments and output."""
    _lanes_shapes(tab, idx)
    q = torch.arange(tab.shape[1], device=tab.device)
    return tab[idx.long()[:, q % idx.shape[1]], q]


def gather_lanes(tab, idx):
    """out[r, q] = tab[idx[r, q % L], q]: lane l of row r reads its own
    table row in each of the table's width / L lane groups.

    Args:
      tab: [c, width] float32 table, width a multiple of L.
      idx: [R, L] int32 table rows in [0, c).
    Returns [R, width] float32.
    """
    _lanes_shapes(tab, idx)
    if _on_cpu(tab, idx):
        return gather_lanes_plain(tab, idx)
    _check_cuda("gather_lanes", dict(tab=tab), dict(idx=idx))
    c, width = tab.shape
    R, L = idx.shape
    w = lane_slab_width(c, width)
    if w == 0:
        raise ValueError(f"gather_lanes: a table of {c} rows: not one column "
                         f"of it fits {LANE_SLAB_BYTES} bytes of shared "
                         "memory")
    out = torch.empty((R, width), device=tab.device, dtype=torch.float32)
    lib = _build.load()
    stream = torch.cuda.current_stream(tab.device).cuda_stream
    err = lib.dgnn_gather_lanes(_ptr(tab), _ptr(idx), c, width, R, L, w,
                                _ptr(out), stream)
    if err:
        raise RuntimeError(f"gather_lanes kernel launch failed: CUDA error "
                           f"{err} (c={c}, width={width}, R={R}, L={L}, "
                           f"slab {w})")
    LAUNCHES["gather_lanes"] += 1
    return out
