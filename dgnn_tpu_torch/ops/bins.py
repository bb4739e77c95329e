"""Per-bin GAT and MoNet passes: CUDA kernel wrappers and their plain
versions.

Port of ``dgnn_tpu/ops/pallas_bins.py``.  ``bin_gat_fwd`` / ``bin_gat_bwd``
launch the hand-written kernels of csrc/bin_gat.cu and ``bin_gmm_node_fwd``
/ ``bin_gmm_node_bwd`` those of csrc/bin_gmm.cu for CUDA tensors, and raise
on anything those kernels do not take.  Beside each is a plain PyTorch
version (``*_plain``) that mirrors the XLA formulation of
``dgnn_tpu/ops/gat.py`` (:166-189 forward, :345-366 backward) and
``dgnn_tpu/ops/gmm.py`` (:436-451, :539-581) with the kernels' output
semantics; the wrapper takes it only when the tensors lie on the CPU.

The kernels gather for themselves from the node tables, given the bin's
slot table ``nbr [S, W]`` and the per-segment ``row [S]`` and
``count [S]``; every bin width runs the kernel.

Feature rows (``feat`` of the forwards; ``g`` and ``feat`` of the
backwards) may be float32 or bfloat16, one type for both tables of a call
(the ops' ``gather_dtype``): the kernels widen bf16 rows to float32 as they
load them, and the plain versions widen the gathered rows the same way.
Every other table is float32, every output float32, and every sum is taken
in float32.

``bin_gat_fwd_list``, ``bin_gat_bwd_list``, ``bin_gmm_node_fwd_list`` and
``bin_gmm_node_bwd_list`` take every bin of one adjacency direction (a
sequence of ``(nbr, row, count)``) in one launch of the same kernel as
their per-bin wrappers, and return the bins' outputs in one tensor each,
bin after bin: the rows that ``torch.cat`` of the per-bin outputs would
give, and so their plain versions.  A direction with more than
``MAX_BINS_PER_LAUNCH`` bins takes one launch per that many.  ``tail`` /
``dx_tail`` rows (the hub block's partials) are copied in after the bins'.

``LAUNCHES`` counts kernel launches per wrapper (a plain int each, added to
only where the kernel is launched), so a run can show that its main path
went through the kernels; a launch of a kernel's bf16 instance counts
under its name with ``_bf16`` appended, and a GAT launch given a table of
global ids (``gid``) with ``_gid`` appended after that (``launch_name``).

``gid`` (the GAT passes, optional): an int32 table that maps the ids of
the call's node tables to the ids the attention-dropout hash takes.  A
graph shard (parallel/partition.py) indexes its sources in an extended
local + halo space; its ``ext_gids`` table gives each extended id its
global node id, so the shard's dropout mask is bit for bit the
single-device graph's.  The hash alone reads it: every gather keeps the
call's own ids.  None hashes the ids as they are.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .common import (gaussian_terms, lane_mask, leaky_relu, leaky_relu_grad,
                     pair_keep, seed_tensor)

__all__ = ["bin_gat_fwd", "bin_gat_fwd_plain", "bin_gat_fwd_list",
           "bin_gat_fwd_list_plain", "bin_gat_bwd", "bin_gat_bwd_plain",
           "bin_gat_bwd_list", "bin_gat_bwd_list_plain", "bin_gmm_node_fwd",
           "bin_gmm_node_fwd_plain", "bin_gmm_node_fwd_list",
           "bin_gmm_node_fwd_list_plain", "bin_gmm_node_bwd",
           "bin_gmm_node_bwd_plain", "bin_gmm_node_bwd_list",
           "bin_gmm_node_bwd_list_plain", "gmm_stat_width", "LAUNCHES",
           "reset_launches", "launch_name", "MAX_HEADS", "MAX_BINS_PER_LAUNCH", "GMM_MAX_K",
           "GMM_MAX_D", "GMM_MAX_KF", "GMM_MAX_COEF"]

# Finite "-inf" the kernels emit as the maximum of an empty segment.
NEG_B = -1e30
# Heads the GAT kernels hold (csrc/bin_gat.cu kMaxHeads).
MAX_HEADS = 16
# Bins one launch of the list kernels takes (csrc/bin_common.cuh kMaxBins,
# graph.binning's largest bin count).
MAX_BINS_PER_LAUNCH = 8
# What the MoNet kernels take (csrc/gmm_common.cuh, csrc/bin_gmm.cu): Gaussian
# kernels, projected pseudo dimensions (also the bound on the raw source- and
# destination-side scalars Ds, Dd), and K*F feature columns.
GMM_MAX_K = 8
GMM_MAX_D = 4
GMM_MAX_KF = 1024
# bin_gmm_node_bwd keeps 3D + D*Dd sums per thread (csrc/bin_gmm.cu kMaxCoef):
# 8 at the models' D = 2, Dd = 1.
GMM_MAX_COEF = 8

LAUNCHES = {name + suffix: 0
            for name in ("bin_gat_fwd", "bin_gat_bwd", "bin_gmm_node_fwd",
                         "bin_gmm_node_bwd")
            for suffix in ("", "_bf16")}
LAUNCHES.update({name + suffix + "_gid": 0
                 for name in ("bin_gat_fwd", "bin_gat_bwd")
                 for suffix in ("", "_bf16")})


def launch_name(name: str, bf16: int, gid: bool = False) -> str:
    """The LAUNCHES key of a launch of ``name``'s float32 or bf16
    instance, given a table of global ids for the dropout hash or not."""
    return name + ("_bf16" if bf16 else "") + ("_gid" if gid else "")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _inv_keep(p: float) -> float:
    return float(np.float32(1.0 / (1.0 - p))) if p > 0 else 1.0


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(devs)}")
    return False


def _row_type(name, rows) -> int:
    """The launchers' bf16 flag for a call's feature-row tables: 0 if all
    are float32, 1 if all are bfloat16; raises for any other type or a
    mix."""
    types = {t.dtype for t in rows.values()}
    if len(types) != 1 or not types <= {torch.float32, torch.bfloat16}:
        got = ", ".join(f"{k} {t.dtype}" for k, t in rows.items())
        raise TypeError(f"{name}: {', '.join(rows)} must be all float32 or "
                        f"all bfloat16 (got {got}); the kernels take those "
                        "two only")
    return int(types == {torch.bfloat16})


def _check_cuda(name, floats, ints, H=None, rows=None):
    """Types, contiguity and heads of a CUDA call; ``rows``: the feature-row
    tables (float32 or bfloat16).  Returns the launchers' bf16 flag."""
    bf16 = 0 if rows is None else _row_type(name, rows)
    for key, t in (rows or {}).items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    for key, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32 (got {t.dtype}); "
                            "the kernels take float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    for key, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32 (got {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if H is not None and not 1 <= H <= MAX_HEADS:
        raise ValueError(f"{name}: {H} heads; the kernel takes 1..{MAX_HEADS}")
    return bf16


def _check_seg(nbr, row, count):
    if nbr.dim() != 2 or row.shape != (nbr.shape[0],) \
            or count.shape != (nbr.shape[0],):
        raise ValueError(f"bad bin shapes: nbr {tuple(nbr.shape)}, row "
                         f"{tuple(row.shape)}, count {tuple(count.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _opt(t):
    """[t], or [] for None: an optional tensor among _on_cpu's."""
    return [] if t is None else [t]


def _seg_tensors(segs):
    return [t for seg in segs for t in seg]


def _seg_ints(segs):
    """A list's slot tables by name, for _check_cuda."""
    return {f"{k}[{b}]": t for b, seg in enumerate(segs)
            for k, t in zip(("nbr", "row", "count"), seg)}


def _check_segs(segs):
    for seg in segs:
        if len(seg) != 3:
            raise ValueError("a bin is (nbr, row, count)")
        _check_seg(*seg)


def _launches(segs):
    """Cut a direction's bins into launches: (first output row, bins) for
    each run of at most MAX_BINS_PER_LAUNCH bins that holds a segment."""
    base = 0
    for i in range(0, len(segs), MAX_BINS_PER_LAUNCH):
        part = segs[i:i + MAX_BINS_PER_LAUNCH]
        rows = sum(nbr.shape[0] for nbr, _, _ in part)
        if rows:
            yield base, part
        base += rows


def _bin_arrays(part):
    """One launch's bins as the C launchers take them: host arrays of the
    nbr, row and count pointers, of S and of W."""
    ptrs, ints = ctypes.c_void_p * len(part), ctypes.c_int * len(part)
    return (ptrs(*(nbr.data_ptr() for nbr, _, _ in part)),
            ptrs(*(row.data_ptr() for _, row, _ in part)),
            ptrs(*(count.data_ptr() for _, _, count in part)),
            ints(*(nbr.shape[0] for nbr, _, _ in part)),
            ints(*(nbr.shape[1] for nbr, _, _ in part)))


def _seed_arg(seed, p, like):
    """The GAT kernels' seed argument: the seed in device memory
    (common.seed_tensor), or None, a null pointer, where p == 0."""
    return seed_tensor(seed, like) if p > 0 else None


def _hash_ids(ids, gid):
    """The ids the dropout hash takes: ``gid[ids]``, or ``ids`` without a
    table."""
    return ids if gid is None else gid.long()[ids]


def _check_gid(name, gid, like):
    """A gid table: 1-D int32, contiguous, on the node tables' device."""
    if gid is None:
        return
    if gid.dim() != 1 or gid.device != like.device:
        raise ValueError(f"{name}: gid must be a 1-D table on "
                         f"{like.device}, got {tuple(gid.shape)} on "
                         f"{gid.device}")
    _check_cuda(name, {}, dict(gid=gid))


def _row_ptr(t, row):
    """Address of row ``row`` of a contiguous output (None stays None)."""
    return None if t is None else (t.data_ptr()
                                   + row * t.stride(0) * t.element_size())


def _cat_rows(parts, shape, like):
    """Rows of ``parts`` one after the other; float32 [0, *shape] on
    ``like``'s device if there are none."""
    if not parts:
        return torch.zeros((0, *shape), dtype=torch.float32,
                           device=like.device)
    return torch.cat(parts)


def _copy_tail(outs, rows, tail):
    """The tail's rows into outs[i][rows:], where both are given."""
    for o, t in zip(outs, tail):
        if o is not None:
            o[rows:].copy_(t)


# ---------------------------------------------------------------------------
# Forward (pass A over the CSR bins)
# ---------------------------------------------------------------------------


def bin_gat_fwd_plain(feat, ac, ar, nbr, row, count, *, slope: float,
                      with_pos: bool, p: float = 0.0, seed=0,
                      gid=None):
    """Plain PyTorch per-bin forward; same arguments and outputs as
    ``bin_gat_fwd``."""
    S, W = nbr.shape
    H = ac.shape[-1]
    mask = lane_mask(count, W)[..., None]                 # [S, W, 1]
    nb = nbr.long()
    rw = row.long()
    sr = ar[rw][:, None, :] + ac[nb]                      # [S, W, H]
    s = torch.where(mask, leaky_relu(sr, slope), NEG_B)
    m = s.amax(dim=1)                                     # [S, H]
    w = torch.where(mask, torch.exp(s - m[:, None, :]), 0.0)
    l = w.sum(dim=1)
    w_agg = (w * pair_keep(seed, _hash_ids(rw, gid)[:, None],
                           _hash_ids(nb, gid), H, p) if p > 0 else w)
    x = feat[nb].float()                                  # [S, W, H, F]
    acc = torch.einsum("swh,swhf->shf", w_agg, x)
    if not with_pos:
        return m, l, None, acc, None
    pos = sr >= 0
    lpos = torch.where(pos, w, 0.0).sum(dim=1)
    accpos = torch.einsum("swh,swhf->shf", torch.where(pos, w_agg, 0.0), x)
    return m, l, lpos, acc, accpos


def bin_gat_fwd(feat, ac, ar, nbr, row, count, *, slope: float,
                with_pos: bool, p: float = 0.0, seed=0, gid=None):
    """One degree bin of the GAT forward (pass A).

    Args:
      feat: [N, H, F] float32 or bfloat16 source features.
      ac: [N, H] float32 source attention coefficients.
      ar: [Nr, H] float32 destination coefficients (indexed by ``row``).
      nbr: [S, W] int32 source id per slot; row, count: [S] int32.
      p, seed: attention-dropout probability and uint32 seed (p = 0: off):
        a Python int or a one-element integer tensor on the tables'
        device, which the kernel reads from device memory
        (ops/common.seed_tensor).
      gid: None, or the int32 table of the ids the dropout hash takes
        (module docstring), indexed by row and by nbr.
    Returns (m, l, lpos, acc, accpos): m, l, lpos [S, H]; acc, accpos
    [S, H, F]; lpos/accpos are None unless ``with_pos``.  m is the exact
    per-segment score maximum, -1e30 for an empty segment.
    """
    _check_seg(nbr, row, count)
    if _on_cpu(feat, ac, ar, nbr, row, count, *_opt(gid)):
        return bin_gat_fwd_plain(feat, ac, ar, nbr, row, count, slope=slope,
                                 with_pos=with_pos, p=p, seed=seed, gid=gid)
    return _gat_fwd_cuda(feat, ac, ar, [(nbr, row, count)], slope, with_pos,
                         p, seed, None, gid)


def bin_gat_fwd_list_plain(feat, ac, ar, segs, *, slope: float,
                           with_pos: bool, p: float = 0.0, seed=0,
                           tail=None, gid=None):
    """Plain PyTorch list forward: the per-bin plain versions, then
    ``torch.cat``; same arguments and outputs as ``bin_gat_fwd_list``."""
    parts = [bin_gat_fwd_plain(feat, ac, ar, *seg, slope=slope,
                               with_pos=with_pos, p=p, seed=seed, gid=gid)
             for seg in segs]
    if tail is not None:
        parts.append(tuple(tail))
    H, F = feat.shape[1:]
    shapes = ((H,), (H,), (H,), (H, F), (H, F))
    return tuple(None if not with_pos and i in (2, 4)
                 else _cat_rows([pt[i] for pt in parts], shapes[i], feat)
                 for i in range(5))


def bin_gat_fwd_list(feat, ac, ar, segs, *, slope: float, with_pos: bool,
                     p: float = 0.0, seed=0, tail=None, gid=None):
    """Every degree bin of a CSR adjacency in one launch of the
    ``bin_gat_fwd`` kernel (one per MAX_BINS_PER_LAUNCH bins).

    Args as ``bin_gat_fwd``, with ``segs`` a sequence of ``(nbr, row,
    count)``, one per bin, and ``tail``: None, or (m, l, lpos, acc, accpos)
    rows to follow the bins' (lpos / accpos None unless ``with_pos``).
    Returns (m, l, lpos, acc, accpos) with sum S_b (+ the tail's) rows, bin
    after bin: ``torch.cat`` of the per-bin outputs and the tail.
    """
    _check_segs(segs)
    tail_t = [] if tail is None else [t for t in tail if t is not None]
    if _on_cpu(feat, ac, ar, *_seg_tensors(segs), *tail_t, *_opt(gid)):
        return bin_gat_fwd_list_plain(feat, ac, ar, segs, slope=slope,
                                      with_pos=with_pos, p=p, seed=seed,
                                      tail=tail, gid=gid)
    return _gat_fwd_cuda(feat, ac, ar, list(segs), slope, with_pos, p, seed,
                         tail, gid)


def _gat_fwd_cuda(feat, ac, ar, segs, slope, with_pos, p, seed, tail, gid):
    N, H, F = feat.shape
    if ac.shape != (N, H) or ar.dim() != 2 or ar.shape[1] != H:
        raise ValueError(f"bin_gat_fwd: feat {tuple(feat.shape)}, ac "
                         f"{tuple(ac.shape)}, ar {tuple(ar.shape)}")
    bf16 = _check_cuda("bin_gat_fwd", dict(ac=ac, ar=ar), _seg_ints(segs), H,
                       rows=dict(feat=feat))
    _check_gid("bin_gat_fwd", gid, feat)
    S = sum(nbr.shape[0] for nbr, _, _ in segs)
    rows = S + (0 if tail is None else tail[0].shape[0])
    new = dict(device=feat.device, dtype=torch.float32)
    outs = (torch.empty((rows, H), **new), torch.empty((rows, H), **new),
            torch.empty((rows, H), **new) if with_pos else None,
            torch.empty((rows, H, F), **new),
            torch.empty((rows, H, F), **new) if with_pos else None)
    seed_t = _seed_arg(seed, p, feat)
    lib = _build.load()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    for base, part in _launches(segs):
        err = lib.dgnn_bin_gat_fwd(
            _ptr(feat), _ptr(ac), _ptr(ar), len(part), *_bin_arrays(part),
            H, F, bf16, float(slope), int(with_pos), float(p), _inv_keep(p),
            _ptr(seed_t), _ptr(gid),
            *(_row_ptr(t, base) for t in outs), stream)
        if err:
            raise RuntimeError(
                f"bin_gat_fwd kernel launch failed: CUDA error {err} (bins "
                f"{[tuple(nbr.shape) for nbr, _, _ in part]}, H={H}, F={F})")
        LAUNCHES[launch_name("bin_gat_fwd", bf16, gid is not None)] += 1
    if tail is not None:
        _copy_tail(outs, S, tail)
    return outs


# ---------------------------------------------------------------------------
# Backward (pass B over the CSC bins)
# ---------------------------------------------------------------------------


def bin_gat_bwd_plain(g, ar, M, Linv, ws, ac, feat, nbr, row, count, *,
                      slope: float, p: float = 0.0, seed=0, gid=None):
    """Plain PyTorch per-bin backward; same arguments and outputs as
    ``bin_gat_bwd``."""
    S, W = nbr.shape
    H = ac.shape[-1]
    mask = lane_mask(count, W)[..., None]
    nb = nbr.long()
    rw = row.long()
    sr = ar[nb] + ac[rw][:, None, :]                      # [S, W, H]
    a = torch.exp(leaky_relu(sr, slope) - M[nb]) * Linv[nb]
    a = torch.where(mask, a, 0.0)
    ah = (a * pair_keep(seed, _hash_ids(nb, gid),
                        _hash_ids(rw, gid)[:, None], H, p) if p > 0 else a)
    gi = g[nb].float()                                    # [S, W, H, F]
    dx = torch.einsum("swh,swhf->shf", ah, gi)
    ge = torch.einsum("shf,swhf->swh", feat[rw].float(), gi)
    u = (ah * ge - a * ws[nb]) * leaky_relu_grad(sr, slope)
    return dx, u.sum(dim=1)


def bin_gat_bwd(g, ar, M, Linv, ws, ac, feat, nbr, row, count, *,
                slope: float, p: float = 0.0, seed=0, gid=None):
    """One degree bin of the GAT backward (pass B, CSC: rows = sources).

    Args:
      g: [Nd, H, F] float32 or bfloat16 gradient of the op's output
        (destination rows).
      ar, M, Linv, ws: [Nd, H] float32 destination tables: attention
        coefficient, merged softmax maximum, 1 / max(L, 1e-20) and
        <g, out>.
      ac: [Ns, H] float32, feat: [Ns, H, F] source tables (feat of g's
        type).
      nbr: [S, W] int32 destination id per slot; row, count: [S] int32.
      gid: None, or the int32 table of the ids the dropout hash takes
        (module docstring), indexed by nbr and by row.
    Returns (dx [S, H, F], dac [S, H]) per segment:
      dx  = sum_w a^ g_w
      dac = sum_w (a^ <x, g_w> - a ws_w) * LeakyReLU'(ar_w + ac)
    """
    _check_seg(nbr, row, count)
    if _on_cpu(g, ar, M, Linv, ws, ac, feat, nbr, row, count, *_opt(gid)):
        return bin_gat_bwd_plain(g, ar, M, Linv, ws, ac, feat, nbr, row,
                                 count, slope=slope, p=p, seed=seed, gid=gid)
    return _gat_bwd_cuda(g, ar, M, Linv, ws, ac, feat, [(nbr, row, count)],
                         slope, p, seed, None, gid)


def bin_gat_bwd_list_plain(g, ar, M, Linv, ws, ac, feat, segs, *,
                           slope: float, p: float = 0.0, seed=0,
                           tail=None, gid=None):
    """Plain PyTorch list backward: the per-bin plain versions, then
    ``torch.cat``; same arguments and outputs as ``bin_gat_bwd_list``."""
    parts = [bin_gat_bwd_plain(g, ar, M, Linv, ws, ac, feat, *seg,
                               slope=slope, p=p, seed=seed, gid=gid)
             for seg in segs]
    if tail is not None:
        parts.append(tuple(tail))
    H, F = feat.shape[1:]
    return (_cat_rows([dx for dx, _ in parts], (H, F), feat),
            _cat_rows([dac for _, dac in parts], (H,), feat))


def bin_gat_bwd_list(g, ar, M, Linv, ws, ac, feat, segs, *, slope: float,
                     p: float = 0.0, seed=0, tail=None, gid=None):
    """Every degree bin of a CSC adjacency in one launch of the
    ``bin_gat_bwd`` kernel (one per MAX_BINS_PER_LAUNCH bins).

    Args as ``bin_gat_bwd``, with ``segs`` a sequence of ``(nbr, row,
    count)``, one per bin, and ``tail``: None, or (dx [T, H, F], dac [T, H])
    rows to follow the bins' (the hub block's).
    Returns (dx [sum S_b + T, H, F], dac [sum S_b + T, H]), bin after bin:
    ``torch.cat`` of the per-bin outputs and the tail.
    """
    _check_segs(segs)
    tail_t = [] if tail is None else list(tail)
    if _on_cpu(g, ar, M, Linv, ws, ac, feat, *_seg_tensors(segs), *tail_t,
               *_opt(gid)):
        return bin_gat_bwd_list_plain(g, ar, M, Linv, ws, ac, feat, segs,
                                      slope=slope, p=p, seed=seed, tail=tail,
                                      gid=gid)
    return _gat_bwd_cuda(g, ar, M, Linv, ws, ac, feat, list(segs), slope, p,
                         seed, tail, gid)


def _gat_bwd_cuda(g, ar, M, Linv, ws, ac, feat, segs, slope, p, seed, tail,
                  gid):
    Nd, H, F = g.shape
    Ns = feat.shape[0]
    for key, t, shape in (("ar", ar, (Nd, H)), ("M", M, (Nd, H)),
                          ("Linv", Linv, (Nd, H)), ("ws", ws, (Nd, H)),
                          ("ac", ac, (Ns, H)), ("feat", feat, (Ns, H, F))):
        if tuple(t.shape) != shape:
            raise ValueError(f"bin_gat_bwd: {key} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    bf16 = _check_cuda("bin_gat_bwd",
                       dict(ar=ar, M=M, Linv=Linv, ws=ws, ac=ac),
                       _seg_ints(segs), H, rows=dict(g=g, feat=feat))
    _check_gid("bin_gat_bwd", gid, g)
    S = sum(nbr.shape[0] for nbr, _, _ in segs)
    rows = S + (0 if tail is None else tail[0].shape[0])
    dx = torch.empty((rows, H, F), device=g.device, dtype=torch.float32)
    dac = torch.empty((rows, H), device=g.device, dtype=torch.float32)
    seed_t = _seed_arg(seed, p, g)
    lib = _build.load()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    for base, part in _launches(segs):
        err = lib.dgnn_bin_gat_bwd(
            _ptr(g), _ptr(ar), _ptr(M), _ptr(Linv), _ptr(ws), _ptr(ac),
            _ptr(feat), len(part), *_bin_arrays(part), H, F, bf16,
            float(slope), float(p), _inv_keep(p), _ptr(seed_t),
            _ptr(gid), _row_ptr(dx, base), _row_ptr(dac, base), stream)
        if err:
            raise RuntimeError(
                f"bin_gat_bwd kernel launch failed: CUDA error {err} (bins "
                f"{[tuple(nbr.shape) for nbr, _, _ in part]}, H={H}, F={F})")
        LAUNCHES[launch_name("bin_gat_bwd", bf16, gid is not None)] += 1
    if tail is not None:
        _copy_tail((dx, dac), S, tail)
    return dx, dac


# ---------------------------------------------------------------------------
# MoNet (GMMConv), node-derived pseudo-coordinates
# ---------------------------------------------------------------------------
#
# The projected pseudo-coordinate of edge (u -> v) is separable:
#   p_d = [tanh](alpha_d[u] + beta_d[v]),
# alpha = sfeat @ pw_s the source-side projection and beta = dfeat @ pw_d +
# bias the destination-side one (ops/gmm.py), and the edge's K Gaussian
# weights are w_k = exp(-0.5 sum_d ((p_d - mu_kd) isig_kd)^2).


def gmm_stat_width(K: int, D: int, Dd: int, Ds: int = 0) -> int:
    """Columns of the backward's per-segment stat row (layout in
    ``bin_gmm_node_bwd``); the hub block's rows have no sfeat block
    (Ds = 0)."""
    return 2 * K * D + D + D * Dd + D * Ds


def _check_gmm(name, K, D, F, Dd=1, Ds=1):
    if not (1 <= K <= GMM_MAX_K and 1 <= D <= GMM_MAX_D
            and 1 <= Dd <= GMM_MAX_D and 1 <= Ds <= GMM_MAX_D):
        raise ValueError(
            f"{name}: K={K} kernels, D={D} pseudo dims, Dd={Dd}, Ds={Ds}; "
            f"the kernel takes K in 1..{GMM_MAX_K} and D, Dd, Ds in "
            f"1..{GMM_MAX_D}")
    if not 1 <= K * F <= GMM_MAX_KF:
        raise ValueError(f"{name}: K*F = {K * F}; the kernel takes at most "
                         f"{GMM_MAX_KF} feature columns")


def _check_gmm_params(name, mu, isig):
    if mu.dim() != 2 or isig.shape != mu.shape:
        raise ValueError(f"{name}: mu {tuple(mu.shape)} and inv_sigma "
                         f"{tuple(isig.shape)} must both be [K, D]")


def bin_gmm_node_fwd_plain(feat, alpha, beta, nbr, row, count, mu, isig, *,
                           use_tanh: bool):
    """Plain PyTorch per-bin forward; same arguments and outputs as
    ``bin_gmm_node_fwd``."""
    W = nbr.shape[1]
    mask = lane_mask(count, W)
    nb = torch.where(mask, nbr, 0).long()  # padded slots are never relied on
    pre = beta[row.long()][:, None, :] + alpha[nb]        # [S, W, D]
    p = torch.tanh(pre) if use_tanh else pre
    w = torch.where(mask[..., None], gaussian_terms(p, mu, isig)[2], 0.0)
    return torch.einsum("swk,swkf->skf", w, feat[nb].float())


def bin_gmm_node_fwd(feat, alpha, beta, nbr, row, count, mu, isig, *,
                     use_tanh: bool):
    """One degree bin of the MoNet forward (CSR: rows = destinations).

    Args:
      feat: [N, K, F] float32 or bfloat16 source features (K Gaussian
        kernels).
      alpha: [N, D] float32 source-side projected pseudo (indexed by nbr).
      beta: [Nr, D] float32 destination-side projection, bias folded in
        (indexed by ``row``).
      nbr: [S, W] int32 source id per slot; row, count: [S] int32.
      mu, isig: [K, D] float32 kernel means and inverse widths.
    Returns acc [S, K, F]: acc[s, k] = sum over the segment's valid slots of
    w_k * feat[nbr, k]; zeros for an empty segment.
    """
    _check_seg(nbr, row, count)
    _check_gmm_params("bin_gmm_node_fwd", mu, isig)
    if _on_cpu(feat, alpha, beta, nbr, row, count, mu, isig):
        return bin_gmm_node_fwd_plain(feat, alpha, beta, nbr, row, count, mu,
                                      isig, use_tanh=use_tanh)
    return _gmm_fwd_cuda(feat, alpha, beta, [(nbr, row, count)], mu, isig,
                         use_tanh, None)


def bin_gmm_node_fwd_list_plain(feat, alpha, beta, segs, mu, isig, *,
                                use_tanh: bool, tail=None):
    """Plain PyTorch list forward: the per-bin plain versions, then
    ``torch.cat``; same arguments and outputs as
    ``bin_gmm_node_fwd_list``."""
    parts = [bin_gmm_node_fwd_plain(feat, alpha, beta, *seg, mu, isig,
                                    use_tanh=use_tanh) for seg in segs]
    return _cat_rows(parts + ([] if tail is None else [tail]),
                     feat.shape[1:], feat)


def bin_gmm_node_fwd_list(feat, alpha, beta, segs, mu, isig, *,
                          use_tanh: bool, tail=None):
    """Every degree bin of a CSR adjacency in one launch of the
    ``bin_gmm_node_fwd`` kernel (one per MAX_BINS_PER_LAUNCH bins).

    Args as ``bin_gmm_node_fwd``, with ``segs`` a sequence of ``(nbr, row,
    count)``, one per bin, and ``tail``: None, or [T, K, F] acc rows to
    follow the bins' (the hub block's).
    Returns acc [sum S_b + T, K, F], bin after bin: ``torch.cat`` of the
    per-bin outputs and the tail.
    """
    _check_segs(segs)
    _check_gmm_params("bin_gmm_node_fwd", mu, isig)
    tail_t = [] if tail is None else [tail]
    if _on_cpu(feat, alpha, beta, *_seg_tensors(segs), mu, isig, *tail_t):
        return bin_gmm_node_fwd_list_plain(feat, alpha, beta, segs, mu, isig,
                                           use_tanh=use_tanh, tail=tail)
    return _gmm_fwd_cuda(feat, alpha, beta, list(segs), mu, isig, use_tanh,
                         tail)


def _gmm_fwd_cuda(feat, alpha, beta, segs, mu, isig, use_tanh, tail):
    N, K, F = feat.shape
    D = mu.shape[1]
    if (mu.shape[0] != K or alpha.shape != (N, D) or beta.dim() != 2
            or beta.shape[1] != D):
        raise ValueError(f"bin_gmm_node_fwd: feat {tuple(feat.shape)}, alpha "
                         f"{tuple(alpha.shape)}, beta {tuple(beta.shape)}, "
                         f"mu {tuple(mu.shape)}")
    _check_gmm("bin_gmm_node_fwd", K, D, F)
    bf16 = _check_cuda("bin_gmm_node_fwd",
                       dict(alpha=alpha, beta=beta, mu=mu, isig=isig),
                       _seg_ints(segs), rows=dict(feat=feat))
    S = sum(nbr.shape[0] for nbr, _, _ in segs)
    rows = S + (0 if tail is None else tail.shape[0])
    acc = torch.empty((rows, K, F), device=feat.device, dtype=torch.float32)
    lib = _build.load()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    for base, part in _launches(segs):
        err = lib.dgnn_bin_gmm_fwd(
            _ptr(feat), _ptr(alpha), _ptr(beta), len(part),
            *_bin_arrays(part), _ptr(mu), _ptr(isig), K, D, F,
            int(use_tanh), bf16, _row_ptr(acc, base), stream)
        if err:
            raise RuntimeError(
                f"bin_gmm_node_fwd kernel launch failed: CUDA error {err} "
                f"(bins {[tuple(nbr.shape) for nbr, _, _ in part]}, K={K}, "
                f"D={D}, F={F})")
        LAUNCHES[launch_name("bin_gmm_node_fwd", bf16)] += 1
    if tail is not None:
        _copy_tail((acc,), S, (tail,))
    return acc


def bin_gmm_node_bwd_plain(g, beta, dfeat, alpha, feat, sfeat, nbr, row,
                           count, mu, isig, *, use_tanh: bool):
    """Plain PyTorch per-bin backward; same arguments and outputs as
    ``bin_gmm_node_bwd``."""
    S, W = nbr.shape
    mask = lane_mask(count, W)
    nb = torch.where(mask, nbr, 0).long()
    rw = row.long()
    pre = alpha[rw][:, None, :] + beta[nb]                # [S, W, D]
    p = torch.tanh(pre) if use_tanh else pre
    diff, t, w = gaussian_terms(p, mu, isig)              # [S, W, K, D], [S, W, K]
    w = torch.where(mask[..., None], w, 0.0)
    gi = g[nb].float()                                    # [S, W, K, F]
    dx = torch.einsum("swk,swkf->skf", w, gi)
    c = torch.einsum("skf,swkf->swk", feat[rw].float(), gi) * w  # [S, W, K]
    ct = c[..., None] * t                                 # [S, W, K, D]
    dpre = -(ct * isig).sum(dim=2)                        # [S, W, D]
    if use_tanh:
        dpre = dpre * (1.0 - p * p)
    rs = dpre.sum(dim=1)                                  # [S, D]
    st = torch.cat([
        ct.sum(dim=1).flatten(1),
        (ct * diff).sum(dim=1).flatten(1),
        rs,
        torch.einsum("swd,swi->sdi", dpre, dfeat[nb]).flatten(1),
        (rs[:, :, None] * sfeat[rw][:, None, :]).flatten(1)], dim=1)
    return dx, st


def bin_gmm_node_bwd(g, beta, dfeat, alpha, feat, sfeat, nbr, row, count, mu,
                     isig, *, use_tanh: bool):
    """One degree bin of the MoNet backward (CSC: rows = sources).

    Args:
      g: [Nd, K, F] float32 or bfloat16 gradient of the op's output
        (destination rows).
      beta: [Nd, D], dfeat: [Nd, Dd] float32 destination tables: projected
        and raw pseudo scalars (indexed by nbr).
      alpha: [Ns, D], feat: [Ns, K, F] (of g's type), sfeat: [Ns, Ds]
        source tables (indexed by ``row``).
      nbr: [S, W] int32 destination id per slot; row, count: [S] int32.
    Returns (dx [S, K, F], st [S, 2KD + D + D*Dd + D*Ds]) per segment, with
    c_k = w_k <feat[row, k], g[nbr, k]>, t_kd = (p_d - mu_kd) isig_kd,
    dp_d = -sum_k c_k t_kd isig_kd and dpre_d = dp_d (1 - p_d^2) under tanh:
      dx = sum_w w_k g[nbr, k]
      st[0:KD]           = sum_w c_k t_kd                (index k*D + d)
      st[KD:2KD]         = sum_w c_k t_kd (p_d - mu_kd)
      st[2KD:2KD+D]      = sum_w dpre_d
      st[.. : +D*Dd]     = sum_w dpre_d dfeat_i[nbr]     (index d*Dd + i)
      st[.. : +D*Ds]     = sum_w dpre_d sfeat_i[row]     (index d*Ds + i)
    """
    _check_seg(nbr, row, count)
    _check_gmm_params("bin_gmm_node_bwd", mu, isig)
    if _on_cpu(g, beta, dfeat, alpha, feat, sfeat, nbr, row, count, mu, isig):
        return bin_gmm_node_bwd_plain(g, beta, dfeat, alpha, feat, sfeat, nbr,
                                      row, count, mu, isig, use_tanh=use_tanh)
    return _gmm_bwd_cuda(g, beta, dfeat, alpha, feat, sfeat,
                         [(nbr, row, count)], mu, isig, use_tanh, None)


def bin_gmm_node_bwd_list_plain(g, beta, dfeat, alpha, feat, sfeat, segs, mu,
                                isig, *, use_tanh: bool, dx_tail=None):
    """Plain PyTorch list backward: the per-bin plain versions, then
    ``torch.cat``; same arguments and outputs as
    ``bin_gmm_node_bwd_list``."""
    parts = [bin_gmm_node_bwd_plain(g, beta, dfeat, alpha, feat, sfeat, *seg,
                                    mu, isig, use_tanh=use_tanh)
             for seg in segs]
    dxs = [dx for dx, _ in parts] + ([] if dx_tail is None else [dx_tail])
    ns = gmm_stat_width(mu.shape[0], mu.shape[1], dfeat.shape[1],
                        sfeat.shape[1])
    return (_cat_rows(dxs, g.shape[1:], g),
            _cat_rows([st for _, st in parts], (ns,), g))


def bin_gmm_node_bwd_list(g, beta, dfeat, alpha, feat, sfeat, segs, mu, isig,
                          *, use_tanh: bool, dx_tail=None):
    """Every degree bin of a CSC adjacency in one launch of the
    ``bin_gmm_node_bwd`` kernel (one per MAX_BINS_PER_LAUNCH bins).

    Args as ``bin_gmm_node_bwd``, with ``segs`` a sequence of ``(nbr, row,
    count)``, one per bin, and ``dx_tail``: None, or [T, K, F] dx rows to
    follow the bins' (the hub block's).
    Returns (dx [sum S_b + T, K, F], st [sum S_b, NS]), bin after bin:
    ``torch.cat`` of the per-bin outputs (and the tail).
    """
    _check_segs(segs)
    _check_gmm_params("bin_gmm_node_bwd", mu, isig)
    tail_t = [] if dx_tail is None else [dx_tail]
    if _on_cpu(g, beta, dfeat, alpha, feat, sfeat, *_seg_tensors(segs), mu,
               isig, *tail_t):
        return bin_gmm_node_bwd_list_plain(g, beta, dfeat, alpha, feat, sfeat,
                                           segs, mu, isig, use_tanh=use_tanh,
                                           dx_tail=dx_tail)
    return _gmm_bwd_cuda(g, beta, dfeat, alpha, feat, sfeat, list(segs), mu,
                         isig, use_tanh, dx_tail)


def _gmm_bwd_cuda(g, beta, dfeat, alpha, feat, sfeat, segs, mu, isig,
                  use_tanh, dx_tail):
    Nd, K, F = g.shape
    Ns = feat.shape[0]
    D = mu.shape[1]
    if dfeat.dim() != 2 or sfeat.dim() != 2:
        raise ValueError(f"bin_gmm_node_bwd: dfeat {tuple(dfeat.shape)} and "
                         f"sfeat {tuple(sfeat.shape)} must be 2-D")
    Dd, Ds = dfeat.shape[1], sfeat.shape[1]
    for key, t, shape in (("beta", beta, (Nd, D)), ("dfeat", dfeat, (Nd, Dd)),
                          ("alpha", alpha, (Ns, D)),
                          ("feat", feat, (Ns, K, F)),
                          ("sfeat", sfeat, (Ns, Ds)), ("mu", mu, (K, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"bin_gmm_node_bwd: {key} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    _check_gmm("bin_gmm_node_bwd", K, D, F, Dd, Ds)
    if 3 * D + D * Dd > GMM_MAX_COEF:
        raise ValueError(f"bin_gmm_node_bwd: D={D}, Dd={Dd}; the kernel takes "
                         f"3D + D*Dd <= {GMM_MAX_COEF}")
    bf16 = _check_cuda("bin_gmm_node_bwd",
                       dict(beta=beta, dfeat=dfeat, alpha=alpha, sfeat=sfeat,
                            mu=mu, isig=isig),
                       _seg_ints(segs), rows=dict(g=g, feat=feat))
    S = sum(nbr.shape[0] for nbr, _, _ in segs)
    rows = S + (0 if dx_tail is None else dx_tail.shape[0])
    dx = torch.empty((rows, K, F), device=g.device, dtype=torch.float32)
    st = torch.empty((S, gmm_stat_width(K, D, Dd, Ds)), device=g.device,
                     dtype=torch.float32)
    lib = _build.load()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    for base, part in _launches(segs):
        err = lib.dgnn_bin_gmm_bwd(
            _ptr(g), _ptr(beta), _ptr(dfeat), _ptr(alpha), _ptr(feat),
            _ptr(sfeat), len(part), *_bin_arrays(part), _ptr(mu), _ptr(isig),
            K, D, Dd, Ds, F, int(use_tanh), bf16, _row_ptr(dx, base),
            _row_ptr(st, base), stream)
        if err:
            raise RuntimeError(
                f"bin_gmm_node_bwd kernel launch failed: CUDA error {err} "
                f"(bins {[tuple(nbr.shape) for nbr, _, _ in part]}, K={K}, "
                f"D={D}, Dd={Dd}, Ds={Ds}, F={F})")
        LAUNCHES[launch_name("bin_gmm_node_bwd", bf16)] += 1
    if dx_tail is not None:
        _copy_tail((dx,), S, (dx_tail,))
    return dx, st
