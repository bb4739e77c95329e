"""Per-bin GAT passes: CUDA kernel wrappers and their plain versions.

Port of the GAT half of ``dgnn_tpu/ops/pallas_bins.py``.  ``bin_gat_fwd``
and ``bin_gat_bwd`` launch the hand-written kernels of csrc/bin_gat.cu for
CUDA tensors and raise on anything those kernels do not take.  Beside each
is a plain PyTorch version (``*_plain``) that mirrors the XLA formulation
of ``dgnn_tpu/ops/gat.py`` (:166-189 forward, :345-366 backward) with the
kernels' output semantics; the wrapper takes it only when the tensors lie
on the CPU.

The kernels gather for themselves from the node tables, given the bin's
slot table ``nbr [S, W]`` and the per-segment ``row [S]`` and
``count [S]``; every bin width runs the kernel.

``LAUNCHES`` counts kernel launches per wrapper (a plain int each, added to
only where the kernel is launched), so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .common import lane_mask, leaky_relu, leaky_relu_grad, pair_keep

__all__ = ["bin_gat_fwd", "bin_gat_fwd_plain", "bin_gat_bwd",
           "bin_gat_bwd_plain", "LAUNCHES", "reset_launches", "MAX_HEADS"]

# Finite "-inf" the kernels emit as the maximum of an empty segment.
NEG_B = -1e30
# Heads per kernel block's shared staging (csrc/bin_gat.cu kMaxHeads).
MAX_HEADS = 16

LAUNCHES = {"bin_gat_fwd": 0, "bin_gat_bwd": 0}


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


def _check_cuda(name, floats, ints, H):
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
    if not 1 <= H <= MAX_HEADS:
        raise ValueError(f"{name}: {H} heads; the kernel takes 1..{MAX_HEADS}")


def _check_seg(nbr, row, count):
    if nbr.dim() != 2 or row.shape != (nbr.shape[0],) \
            or count.shape != (nbr.shape[0],):
        raise ValueError(f"bad bin shapes: nbr {tuple(nbr.shape)}, row "
                         f"{tuple(row.shape)}, count {tuple(count.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# Forward (pass A over the CSR bins)
# ---------------------------------------------------------------------------


def bin_gat_fwd_plain(feat, ac, ar, nbr, row, count, *, slope: float,
                      with_pos: bool, p: float = 0.0, seed: int = 0):
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
    w_agg = w * pair_keep(seed, rw[:, None], nb, H, p) if p > 0 else w
    x = feat[nb]                                          # [S, W, H, F]
    acc = torch.einsum("swh,swhf->shf", w_agg, x)
    if not with_pos:
        return m, l, None, acc, None
    pos = sr >= 0
    lpos = torch.where(pos, w, 0.0).sum(dim=1)
    accpos = torch.einsum("swh,swhf->shf", torch.where(pos, w_agg, 0.0), x)
    return m, l, lpos, acc, accpos


def bin_gat_fwd(feat, ac, ar, nbr, row, count, *, slope: float,
                with_pos: bool, p: float = 0.0, seed: int = 0):
    """One degree bin of the GAT forward (pass A).

    Args:
      feat: [N, H, F] float32 source features.
      ac: [N, H] float32 source attention coefficients.
      ar: [Nr, H] float32 destination coefficients (indexed by ``row``).
      nbr: [S, W] int32 source id per slot; row, count: [S] int32.
      p, seed: attention-dropout probability and uint32 seed (p = 0: off).
    Returns (m, l, lpos, acc, accpos): m, l, lpos [S, H]; acc, accpos
    [S, H, F]; lpos/accpos are None unless ``with_pos``.  m is the exact
    per-segment score maximum, -1e30 for an empty segment.
    """
    _check_seg(nbr, row, count)
    if _on_cpu(feat, ac, ar, nbr, row, count):
        return bin_gat_fwd_plain(feat, ac, ar, nbr, row, count, slope=slope,
                                 with_pos=with_pos, p=p, seed=seed)
    N, H, F = feat.shape
    if ac.shape != (N, H) or ar.dim() != 2 or ar.shape[1] != H:
        raise ValueError(f"bin_gat_fwd: feat {tuple(feat.shape)}, ac "
                         f"{tuple(ac.shape)}, ar {tuple(ar.shape)}")
    _check_cuda("bin_gat_fwd", dict(feat=feat, ac=ac, ar=ar),
                dict(nbr=nbr, row=row, count=count), H)
    S, W = nbr.shape
    new = dict(device=feat.device, dtype=torch.float32)
    m = torch.empty((S, H), **new)
    l = torch.empty((S, H), **new)
    acc = torch.empty((S, H, F), **new)
    lpos = torch.empty((S, H), **new) if with_pos else None
    accpos = torch.empty((S, H, F), **new) if with_pos else None
    lib = _build.load()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = lib.dgnn_bin_gat_fwd(
        _ptr(feat), _ptr(ac), _ptr(ar), _ptr(nbr), _ptr(row), _ptr(count),
        S, W, H, F, float(slope), int(with_pos), float(p), _inv_keep(p),
        int(seed) & 0xFFFFFFFF, _ptr(m), _ptr(l), _ptr(lpos), _ptr(acc),
        _ptr(accpos), stream)
    if err:
        raise RuntimeError(f"bin_gat_fwd kernel launch failed: CUDA error "
                           f"{err} (S={S}, W={W}, H={H}, F={F})")
    LAUNCHES["bin_gat_fwd"] += 1
    return m, l, lpos, acc, accpos


# ---------------------------------------------------------------------------
# Backward (pass B over the CSC bins)
# ---------------------------------------------------------------------------


def bin_gat_bwd_plain(g, ar, M, Linv, ws, ac, feat, nbr, row, count, *,
                      slope: float, p: float = 0.0, seed: int = 0):
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
    ah = a * pair_keep(seed, nb, rw[:, None], H, p) if p > 0 else a
    gi = g[nb]                                            # [S, W, H, F]
    dx = torch.einsum("swh,swhf->shf", ah, gi)
    ge = torch.einsum("shf,swhf->swh", feat[rw], gi)
    u = (ah * ge - a * ws[nb]) * leaky_relu_grad(sr, slope)
    return dx, u.sum(dim=1)


def bin_gat_bwd(g, ar, M, Linv, ws, ac, feat, nbr, row, count, *,
                slope: float, p: float = 0.0, seed: int = 0):
    """One degree bin of the GAT backward (pass B, CSC: rows = sources).

    Args:
      g: [Nd, H, F] float32 gradient of the op's output (destination rows).
      ar, M, Linv, ws: [Nd, H] float32 destination tables: attention
        coefficient, merged softmax maximum, 1 / max(L, 1e-20) and
        <g, out>.
      ac: [Ns, H], feat: [Ns, H, F] float32 source tables.
      nbr: [S, W] int32 destination id per slot; row, count: [S] int32.
    Returns (dx [S, H, F], dac [S, H]) per segment:
      dx  = sum_w a^ g_w
      dac = sum_w (a^ <x, g_w> - a ws_w) * LeakyReLU'(ar_w + ac)
    """
    _check_seg(nbr, row, count)
    if _on_cpu(g, ar, M, Linv, ws, ac, feat, nbr, row, count):
        return bin_gat_bwd_plain(g, ar, M, Linv, ws, ac, feat, nbr, row,
                                 count, slope=slope, p=p, seed=seed)
    Nd, H, F = g.shape
    Ns = feat.shape[0]
    for key, t, shape in (("ar", ar, (Nd, H)), ("M", M, (Nd, H)),
                          ("Linv", Linv, (Nd, H)), ("ws", ws, (Nd, H)),
                          ("ac", ac, (Ns, H)), ("feat", feat, (Ns, H, F))):
        if tuple(t.shape) != shape:
            raise ValueError(f"bin_gat_bwd: {key} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    _check_cuda("bin_gat_bwd",
                dict(g=g, ar=ar, M=M, Linv=Linv, ws=ws, ac=ac, feat=feat),
                dict(nbr=nbr, row=row, count=count), H)
    S, W = nbr.shape
    dx = torch.empty((S, H, F), device=g.device, dtype=torch.float32)
    dac = torch.empty((S, H), device=g.device, dtype=torch.float32)
    lib = _build.load()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.dgnn_bin_gat_bwd(
        _ptr(g), _ptr(ar), _ptr(M), _ptr(Linv), _ptr(ws), _ptr(ac),
        _ptr(feat), _ptr(nbr), _ptr(row), _ptr(count), S, W, H, F,
        float(slope), float(p), _inv_keep(p), int(seed) & 0xFFFFFFFF,
        _ptr(dx), _ptr(dac), stream)
    if err:
        raise RuntimeError(f"bin_gat_bwd kernel launch failed: CUDA error "
                           f"{err} (S={S}, W={W}, H={H}, F={F})")
    LAUNCHES["bin_gat_bwd"] += 1
    return dx, dac
