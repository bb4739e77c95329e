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

``LAUNCHES`` counts kernel launches per wrapper (a plain int each, added to
only where the kernel is launched), so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .common import (gaussian_terms, lane_mask, leaky_relu, leaky_relu_grad,
                     pair_keep)

__all__ = ["bin_gat_fwd", "bin_gat_fwd_plain", "bin_gat_bwd",
           "bin_gat_bwd_plain", "bin_gmm_node_fwd", "bin_gmm_node_fwd_plain",
           "bin_gmm_node_bwd", "bin_gmm_node_bwd_plain", "gmm_stat_width",
           "LAUNCHES", "reset_launches", "MAX_HEADS", "GMM_MAX_K",
           "GMM_MAX_D", "GMM_MAX_KF", "GMM_MAX_COEF"]

# Finite "-inf" the kernels emit as the maximum of an empty segment.
NEG_B = -1e30
# Heads per kernel block's shared staging (csrc/bin_gat.cu kMaxHeads).
MAX_HEADS = 16
# What the MoNet kernels take (csrc/gmm_common.cuh, csrc/bin_gmm.cu): Gaussian
# kernels, projected pseudo dimensions (also the bound on the raw source- and
# destination-side scalars Ds, Dd), and K*F feature columns.
GMM_MAX_K = 8
GMM_MAX_D = 4
GMM_MAX_KF = 1024
# bin_gmm_node_bwd keeps 3D + D*Dd sums per thread (csrc/bin_gmm.cu kMaxCoef):
# 8 at the models' D = 2, Dd = 1.
GMM_MAX_COEF = 8

LAUNCHES = {"bin_gat_fwd": 0, "bin_gat_bwd": 0,
            "bin_gmm_node_fwd": 0, "bin_gmm_node_bwd": 0}


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


def _check_cuda(name, floats, ints, H=None):
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
    return torch.einsum("swk,swkf->skf", w, feat[nb])


def bin_gmm_node_fwd(feat, alpha, beta, nbr, row, count, mu, isig, *,
                     use_tanh: bool):
    """One degree bin of the MoNet forward (CSR: rows = destinations).

    Args:
      feat: [N, K, F] float32 source features (K Gaussian kernels).
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
    N, K, F = feat.shape
    D = mu.shape[1]
    if (mu.shape[0] != K or alpha.shape != (N, D) or beta.dim() != 2
            or beta.shape[1] != D):
        raise ValueError(f"bin_gmm_node_fwd: feat {tuple(feat.shape)}, alpha "
                         f"{tuple(alpha.shape)}, beta {tuple(beta.shape)}, "
                         f"mu {tuple(mu.shape)}")
    _check_gmm("bin_gmm_node_fwd", K, D, F)
    _check_cuda("bin_gmm_node_fwd",
                dict(feat=feat, alpha=alpha, beta=beta, mu=mu, isig=isig),
                dict(nbr=nbr, row=row, count=count))
    S, W = nbr.shape
    acc = torch.empty((S, K, F), device=feat.device, dtype=torch.float32)
    lib = _build.load()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = lib.dgnn_bin_gmm_fwd(
        _ptr(feat), _ptr(alpha), _ptr(beta), _ptr(nbr), _ptr(row),
        _ptr(count), _ptr(mu), _ptr(isig), S, W, K, D, F, int(use_tanh),
        _ptr(acc), stream)
    if err:
        raise RuntimeError(f"bin_gmm_node_fwd kernel launch failed: CUDA "
                           f"error {err} (S={S}, W={W}, K={K}, D={D}, F={F})")
    LAUNCHES["bin_gmm_node_fwd"] += 1
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
    gi = g[nb]                                            # [S, W, K, F]
    dx = torch.einsum("swk,swkf->skf", w, gi)
    c = torch.einsum("skf,swkf->swk", feat[rw], gi) * w   # [S, W, K]
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
      g: [Nd, K, F] float32 gradient of the op's output (destination rows).
      beta: [Nd, D], dfeat: [Nd, Dd] float32 destination tables: projected
        and raw pseudo scalars (indexed by nbr).
      alpha: [Ns, D], feat: [Ns, K, F], sfeat: [Ns, Ds] float32 source
        tables (indexed by ``row``).
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
    _check_cuda("bin_gmm_node_bwd",
                dict(g=g, beta=beta, dfeat=dfeat, alpha=alpha, feat=feat,
                     sfeat=sfeat, mu=mu, isig=isig),
                dict(nbr=nbr, row=row, count=count))
    S, W = nbr.shape
    dx = torch.empty((S, K, F), device=g.device, dtype=torch.float32)
    st = torch.empty((S, gmm_stat_width(K, D, Dd, Ds)), device=g.device,
                     dtype=torch.float32)
    lib = _build.load()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.dgnn_bin_gmm_bwd(
        _ptr(g), _ptr(beta), _ptr(dfeat), _ptr(alpha), _ptr(feat),
        _ptr(sfeat), _ptr(nbr), _ptr(row), _ptr(count), _ptr(mu), _ptr(isig),
        S, W, K, D, Dd, Ds, F, int(use_tanh), _ptr(dx), _ptr(st), stream)
    if err:
        raise RuntimeError(f"bin_gmm_node_bwd kernel launch failed: CUDA "
                           f"error {err} (S={S}, W={W}, K={K}, D={D}, "
                           f"Dd={Dd}, Ds={Ds}, F={F})")
    LAUNCHES["bin_gmm_node_bwd"] += 1
    return dx, st
