"""Dense hub-block GAT and MoNet passes: CUDA kernel wrappers and their
plain versions.

Port of ``dgnn_tpu/ops/pallas_dense.py``.  ``dense_gat_fwd`` /
``dense_gat_bwd`` launch the hand-written kernels of csrc/dense_gat.cu and
``dense_gmm_fwd`` / ``dense_gmm_bwd`` those of csrc/dense_gmm.cu for CUDA
tensors, and raise on anything those kernels do not take.  Beside each is a
plain PyTorch version (``*_plain``) with the same arguments and outputs;
the wrapper takes it only when the tensors lie on the CPU.

The block (graph.structure.DenseBlock) is a tile-sparse adjacency between
its rows (``row_ids``) and columns (``col_ids``), walked by the schedule
(rc, ct) one [DENSE_RT x DENSE_CT] tile at a time.  Both the kernels and the
plain versions read the node tables by those ids and skip the pairs whose
mask bit is clear (a masked pair contributes exactly 0 in the TPU kernel).
The plain versions take one tile at a time, so their memory is bounded by
a tile's edges at any schedule length.

``dense_dtype`` follows the JAX ops: "bfloat16" (the default) rounds the
operands the TPU kernel feeds its matmuls to bf16 and sums in float32
(GAT: forward p^ and x, backward a^, g and x; MoNet: forward w_k and x,
backward w_k and g for dx, x and g for <x, g>, while c_k = <x, g> w_k and
the stat rows use the unrounded w_k); "float32" rounds nothing.

``LAUNCHES`` counts kernel launches per wrapper (a plain int each, added to
only where the kernel is launched).
"""

from __future__ import annotations

import torch

from ..graph.hub import DENSE_CT, DENSE_RT
from . import _build
from .bins import (_check_cuda, _check_gmm, _check_gmm_params, _inv_keep,
                   _on_cpu, _ptr, gmm_stat_width)
from .common import gaussian_terms, leaky_relu, leaky_relu_grad, pair_keep

__all__ = ["dense_gat_fwd", "dense_gat_fwd_plain", "dense_gat_bwd",
           "dense_gat_bwd_plain", "dense_gmm_fwd", "dense_gmm_fwd_plain",
           "dense_gmm_bwd", "dense_gmm_bwd_plain", "unpack_mask", "LAUNCHES",
           "reset_launches", "DENSE_DTYPES", "MAX_HF"]

DENSE_DTYPES = ("bfloat16", "float32")
# Feature columns the kernels take: 32 lanes x at most 32 columns each.
MAX_HF = 1024

LAUNCHES = {"dense_gat_fwd": 0, "dense_gat_bwd": 0,
            "dense_gmm_fwd": 0, "dense_gmm_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def unpack_mask(bits_u8: torch.Tensor) -> torch.Tensor:
    """[Rt, Ct//8] uint8 (bit-plane layout) -> [Rt, Ct] int32 in {0, 1}:
    column j of a row is byte j % (Ct//8), bit j // (Ct//8)."""
    b = bits_u8.to(torch.int32)
    return torch.cat([(b >> k) & 1 for k in range(8)], dim=1)


def _rounder(dense_dtype: str):
    if dense_dtype not in DENSE_DTYPES:
        raise ValueError(f"dense_dtype must be one of {DENSE_DTYPES}, got "
                         f"{dense_dtype!r}")
    if dense_dtype == "float32":
        return lambda v: v
    return lambda v: v.to(torch.bfloat16).to(torch.float32)


def _tiles(db):
    """Per schedule entry: (block rows, block cols) of the set pairs, int64."""
    for t, (rc, ct) in enumerate(zip(db.rc.tolist(), db.ct.tolist())):
        r, c = torch.nonzero(unpack_mask(db.mask[t]), as_tuple=True)
        yield r + rc * DENSE_RT, c + ct * DENSE_CT


def _col_max(ac, db):
    """Per head, the max of ac over ALL the block's columns, padded ids
    included (pallas_dense.py:295): the rows' score bound uses it."""
    return ac.index_select(0, db.col_ids.long()).amax(dim=0)


# ---------------------------------------------------------------------------
# Forward (pass A over the block: rows = destinations, cols = sources)
# ---------------------------------------------------------------------------


def dense_gat_fwd_plain(db, ar, ac, feat, *, slope: float, with_pos: bool,
                        p: float = 0.0, seed: int = 0,
                        dense_dtype: str = "bfloat16"):
    """Plain PyTorch hub-block forward; same arguments and outputs as
    ``dense_gat_fwd``."""
    rnd = _rounder(dense_dtype)
    H, F = feat.shape[1], feat.shape[2]
    rid_all = db.row_ids.long()
    cid_all = db.col_ids.long()
    R = rid_all.shape[0]
    bound = leaky_relu(ar[rid_all] + _col_max(ac, db)[None, :], slope)
    new = dict(device=feat.device, dtype=torch.float32)
    l = torch.zeros((R, H), **new)
    acc = torch.zeros((R, H, F), **new)
    lpos = torch.zeros((R, H), **new) if with_pos else None
    accpos = torch.zeros((R, H, F), **new) if with_pos else None
    for rows, cols in _tiles(db):
        rid, cid = rid_all[rows], cid_all[cols]
        s_raw = ar[rid] + ac[cid]                          # [E, H]
        pw = torch.exp(leaky_relu(s_raw, slope) - bound[rows])
        pd = rnd(pw * pair_keep(seed, rid, cid, H, p) if p > 0 else pw)
        # l sums the undropped p: bf16-rounded without dropout (the TPU
        # kernel's matmul ones column), float32 with it
        lw = pw if p > 0 else pd
        x = rnd(feat[cid])                                 # [E, H, F]
        l.index_add_(0, rows, lw)
        acc.index_add_(0, rows, pd[..., None] * x)
        if with_pos:
            pos = s_raw >= 0
            lpos.index_add_(0, rows, torch.where(pos, lw, 0.0))
            accpos.index_add_(0, rows,
                              torch.where(pos, pd, 0.0)[..., None] * x)
    return bound, l, lpos, acc, accpos


def _check_block(name, db, HF, H=None):
    T = db.mask.shape[0]
    R, C = db.row_ids.shape[0], db.col_ids.shape[0]
    if (db.mask.dtype != torch.uint8 or db.mask.dim() != 3
            or tuple(db.mask.shape[1:]) != (DENSE_RT, DENSE_CT // 8)):
        raise ValueError(f"{name}: mask must be uint8 [T, {DENSE_RT}, "
                         f"{DENSE_CT // 8}], got {db.mask.dtype} "
                         f"{tuple(db.mask.shape)}")
    if not db.mask.is_contiguous() or db.mask.data_ptr() % 4:
        raise ValueError(f"{name}: mask must be contiguous and 4-byte "
                         "aligned (the kernels read it as 32-bit words)")
    if R % DENSE_RT or C % DENSE_CT:
        raise ValueError(f"{name}: block of {R} x {C}; rows must be a "
                         f"multiple of {DENSE_RT}, columns of {DENSE_CT}")
    if (db.rc.shape != (T,) or db.ct.shape != (T,)
            or db.chunk_ptr.shape != (R // DENSE_RT + 1,)):
        raise ValueError(f"{name}: schedule shapes rc {tuple(db.rc.shape)}, "
                         f"ct {tuple(db.ct.shape)}, chunk_ptr "
                         f"{tuple(db.chunk_ptr.shape)} for T={T}, R={R}")
    if HF > MAX_HF:
        raise ValueError(f"{name}: H*F = {HF}; the kernel takes at most "
                         f"{MAX_HF} feature columns")
    _check_cuda(name, {}, dict(row_ids=db.row_ids, col_ids=db.col_ids,
                               ct=db.ct, chunk_ptr=db.chunk_ptr), H)


def dense_gat_fwd(db, ar, ac, feat, *, slope: float, with_pos: bool,
                  p: float = 0.0, seed: int = 0,
                  dense_dtype: str = "bfloat16"):
    """The hub block's share of the GAT forward (pass A).

    Args:
      db: graph.structure.DenseBlock of the forward direction.
      ar: [Nr, H] float32 destination coefficients (indexed by row_ids).
      ac: [N, H] float32 source coefficients, feat: [N, H, F] float32
        source features (indexed by col_ids).
      p, seed: attention-dropout probability and uint32 seed (p = 0: off),
        hashed on the global ids (dst = row_ids[r], src = col_ids[c]).
      dense_dtype: "bfloat16" or "float32" (module docstring).
    Returns (m, l, lpos, acc, accpos) per block row: m, l, lpos [R, H];
    acc, accpos [R, H, F]; lpos/accpos are None unless ``with_pos``.  m is
    the row's score bound LeakyReLU(ar + max ac), not the exact maximum; a
    row with no edge in the block has l = 0 and acc = 0.
    """
    if _on_cpu(ar, ac, feat, db.mask, db.row_ids, db.col_ids, db.chunk_ptr):
        return dense_gat_fwd_plain(db, ar, ac, feat, slope=slope,
                                   with_pos=with_pos, p=p, seed=seed,
                                   dense_dtype=dense_dtype)
    _rounder(dense_dtype)
    N, H, F = feat.shape
    if ac.shape != (N, H) or ar.dim() != 2 or ar.shape[1] != H:
        raise ValueError(f"dense_gat_fwd: feat {tuple(feat.shape)}, ac "
                         f"{tuple(ac.shape)}, ar {tuple(ar.shape)}")
    _check_cuda("dense_gat_fwd", dict(feat=feat, ac=ac, ar=ar), {}, H)
    _check_block("dense_gat_fwd", db, H * F, H)
    R = db.row_ids.shape[0]
    acmax = _col_max(ac, db).contiguous()
    new = dict(device=feat.device, dtype=torch.float32)
    m = torch.empty((R, H), **new)
    l = torch.empty((R, H), **new)
    acc = torch.empty((R, H, F), **new)
    lpos = torch.empty((R, H), **new) if with_pos else None
    accpos = torch.empty((R, H, F), **new) if with_pos else None
    lib = _build.load()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = lib.dgnn_dense_gat_fwd(
        _ptr(feat), _ptr(ac), _ptr(ar), _ptr(acmax), _ptr(db.row_ids),
        _ptr(db.col_ids), _ptr(db.mask), _ptr(db.ct), _ptr(db.chunk_ptr),
        R, H, F, float(slope), int(with_pos), float(p), _inv_keep(p),
        int(seed) & 0xFFFFFFFF, int(dense_dtype == "bfloat16"), _ptr(m),
        _ptr(l), _ptr(lpos), _ptr(acc), _ptr(accpos), stream)
    if err:
        raise RuntimeError(f"dense_gat_fwd kernel launch failed: CUDA error "
                           f"{err} (R={R}, H={H}, F={F})")
    LAUNCHES["dense_gat_fwd"] += 1
    return m, l, lpos, acc, accpos


# ---------------------------------------------------------------------------
# Backward (pass B over the transposed block: rows = sources, cols = dsts)
# ---------------------------------------------------------------------------


def dense_gat_bwd_plain(db, g, ar, M, Linv, ws, ac, feat, *, slope: float,
                        p: float = 0.0, seed: int = 0,
                        dense_dtype: str = "bfloat16"):
    """Plain PyTorch hub-block backward; same arguments and outputs as
    ``dense_gat_bwd``."""
    rnd = _rounder(dense_dtype)
    H, F = feat.shape[1], feat.shape[2]
    sid_all = db.row_ids.long()
    did_all = db.col_ids.long()
    R = sid_all.shape[0]
    dx = torch.zeros((R, H, F), device=g.device, dtype=torch.float32)
    dac = torch.zeros((R, H), device=g.device, dtype=torch.float32)
    for rows, cols in _tiles(db):
        sid, did = sid_all[rows], did_all[cols]
        s_raw = ar[did] + ac[sid]                          # [E, H]
        a = torch.exp(leaky_relu(s_raw, slope) - M[did]) * Linv[did]
        ah = a * pair_keep(seed, did, sid, H, p) if p > 0 else a
        gi = rnd(g[did])                                   # [E, H, F]
        dx.index_add_(0, rows, rnd(ah)[..., None] * gi)
        ge = (rnd(feat[sid]) * gi).sum(dim=-1)             # [E, H]
        u = (ah * ge - a * ws[did]) * leaky_relu_grad(s_raw, slope)
        dac.index_add_(0, rows, u)
    return dx, dac


def dense_gat_bwd(db, g, ar, M, Linv, ws, ac, feat, *, slope: float,
                  p: float = 0.0, seed: int = 0,
                  dense_dtype: str = "bfloat16"):
    """The hub block's share of the GAT backward (pass B).

    Args:
      db: graph.structure.DenseBlock of the BACKWARD direction: rows are
        sources (row_ids), columns destinations (col_ids).
      g: [Nd, H, F] float32 gradient of the op's output (destinations).
      ar, M, Linv, ws: [Nd, H] float32 destination tables (as bins.bin_gat_bwd).
      ac: [Ns, H], feat: [Ns, H, F] float32 source tables.
      p, seed: attention dropout, hashed on the global ids (dst =
        col_ids[c], src = row_ids[r]), so the mask matches the forward's.
    Returns (dx [R, H, F], dac [R, H]) per block row:
      dx  = sum_c a^ g_c
      dac = sum_c (a^ <x, g_c> - a ws_c) * LeakyReLU'(ar_c + ac)
    """
    if _on_cpu(g, ar, M, Linv, ws, ac, feat, db.mask, db.row_ids,
               db.col_ids, db.chunk_ptr):
        return dense_gat_bwd_plain(db, g, ar, M, Linv, ws, ac, feat,
                                   slope=slope, p=p, seed=seed,
                                   dense_dtype=dense_dtype)
    _rounder(dense_dtype)
    Nd, H, F = g.shape
    Ns = feat.shape[0]
    for key, t, shape in (("ar", ar, (Nd, H)), ("M", M, (Nd, H)),
                          ("Linv", Linv, (Nd, H)), ("ws", ws, (Nd, H)),
                          ("ac", ac, (Ns, H)), ("feat", feat, (Ns, H, F))):
        if tuple(t.shape) != shape:
            raise ValueError(f"dense_gat_bwd: {key} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    _check_cuda("dense_gat_bwd",
                dict(g=g, ar=ar, M=M, Linv=Linv, ws=ws, ac=ac, feat=feat),
                {}, H)
    _check_block("dense_gat_bwd", db, H * F, H)
    R = db.row_ids.shape[0]
    dx = torch.empty((R, H, F), device=g.device, dtype=torch.float32)
    dac = torch.empty((R, H), device=g.device, dtype=torch.float32)
    lib = _build.load()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.dgnn_dense_gat_bwd(
        _ptr(g), _ptr(ar), _ptr(M), _ptr(Linv), _ptr(ws), _ptr(ac),
        _ptr(feat), _ptr(db.row_ids), _ptr(db.col_ids), _ptr(db.mask),
        _ptr(db.ct), _ptr(db.chunk_ptr), R, H, F, float(slope), float(p),
        _inv_keep(p), int(seed) & 0xFFFFFFFF, int(dense_dtype == "bfloat16"),
        _ptr(dx), _ptr(dac), stream)
    if err:
        raise RuntimeError(f"dense_gat_bwd kernel launch failed: CUDA error "
                           f"{err} (R={R}, H={H}, F={F})")
    LAUNCHES["dense_gat_bwd"] += 1
    return dx, dac


# ---------------------------------------------------------------------------
# MoNet (GMMConv), node-derived pseudo-coordinates (see ops/bins.py)
# ---------------------------------------------------------------------------


def dense_gmm_fwd_plain(db, beta, alpha, feat, mu, isig, *, use_tanh: bool,
                        dense_dtype: str = "bfloat16"):
    """Plain PyTorch hub-block MoNet forward; same arguments and output as
    ``dense_gmm_fwd``."""
    rnd = _rounder(dense_dtype)
    rid_all = db.row_ids.long()
    cid_all = db.col_ids.long()
    acc = torch.zeros((rid_all.shape[0],) + tuple(feat.shape[1:]),
                      device=feat.device, dtype=torch.float32)
    for rows, cols in _tiles(db):
        cid = cid_all[cols]
        pre = beta[rid_all[rows]] + alpha[cid]             # [E, D]
        p = torch.tanh(pre) if use_tanh else pre
        w = gaussian_terms(p, mu, isig)[2]                 # [E, K]
        acc.index_add_(0, rows, rnd(w)[..., None] * rnd(feat[cid]))
    return acc


def dense_gmm_fwd(db, beta, alpha, feat, mu, isig, *, use_tanh: bool,
                  dense_dtype: str = "bfloat16"):
    """The hub block's share of the MoNet forward.

    Args:
      db: graph.structure.DenseBlock of the forward direction.
      beta: [Nr, D] float32 destination-side projection, bias folded in
        (indexed by row_ids).
      alpha: [N, D] float32 source-side projection, feat: [N, K, F] float32
        source features (indexed by col_ids).
      mu, isig: [K, D] float32 kernel means and inverse widths.
      dense_dtype: "bfloat16" or "float32" (module docstring).
    Returns acc [R, K, F] per block row: the sum over the row's set columns
    of w_k * feat[col, k]; zeros for a row with no edge in the block.
    """
    _check_gmm_params("dense_gmm_fwd", mu, isig)
    if _on_cpu(beta, alpha, feat, mu, isig, db.mask, db.row_ids, db.col_ids,
               db.chunk_ptr):
        return dense_gmm_fwd_plain(db, beta, alpha, feat, mu, isig,
                                   use_tanh=use_tanh, dense_dtype=dense_dtype)
    _rounder(dense_dtype)
    N, K, F = feat.shape
    D = mu.shape[1]
    if (mu.shape[0] != K or alpha.shape != (N, D) or beta.dim() != 2
            or beta.shape[1] != D):
        raise ValueError(f"dense_gmm_fwd: feat {tuple(feat.shape)}, alpha "
                         f"{tuple(alpha.shape)}, beta {tuple(beta.shape)}, "
                         f"mu {tuple(mu.shape)}")
    _check_gmm("dense_gmm_fwd", K, D, F)
    _check_cuda("dense_gmm_fwd",
                dict(feat=feat, alpha=alpha, beta=beta, mu=mu, isig=isig), {})
    _check_block("dense_gmm_fwd", db, K * F)
    R = db.row_ids.shape[0]
    acc = torch.empty((R, K, F), device=feat.device, dtype=torch.float32)
    lib = _build.load()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = lib.dgnn_dense_gmm_fwd(
        _ptr(feat), _ptr(alpha), _ptr(beta), _ptr(db.row_ids),
        _ptr(db.col_ids), _ptr(db.mask), _ptr(db.ct), _ptr(db.chunk_ptr),
        _ptr(mu), _ptr(isig), R, K, D, F, int(use_tanh),
        int(dense_dtype == "bfloat16"), _ptr(acc), stream)
    if err:
        raise RuntimeError(f"dense_gmm_fwd kernel launch failed: CUDA error "
                           f"{err} (R={R}, K={K}, D={D}, F={F})")
    LAUNCHES["dense_gmm_fwd"] += 1
    return acc


def dense_gmm_bwd_plain(db, g, beta, dfeat, alpha, feat, mu, isig, *,
                        use_tanh: bool, dense_dtype: str = "bfloat16"):
    """Plain PyTorch hub-block MoNet backward; same arguments and outputs
    as ``dense_gmm_bwd``."""
    rnd = _rounder(dense_dtype)
    K, D = mu.shape
    sid_all = db.row_ids.long()
    did_all = db.col_ids.long()
    R = sid_all.shape[0]
    dx = torch.zeros((R,) + tuple(feat.shape[1:]), device=g.device,
                     dtype=torch.float32)
    st = torch.zeros((R, gmm_stat_width(K, D, dfeat.shape[1])),
                     device=g.device, dtype=torch.float32)
    for rows, cols in _tiles(db):
        sid, did = sid_all[rows], did_all[cols]
        pre = alpha[sid] + beta[did]                       # [E, D]
        p = torch.tanh(pre) if use_tanh else pre
        diff, t, w = gaussian_terms(p, mu, isig)           # [E, K, D], [E, K]
        gi = rnd(g[did])                                   # [E, K, F]
        dx.index_add_(0, rows, rnd(w)[..., None] * gi)
        c = (rnd(feat[sid]) * gi).sum(dim=-1) * w          # [E, K]
        ct = c[..., None] * t                              # [E, K, D]
        dpre = -(ct * isig).sum(dim=1)                     # [E, D]
        if use_tanh:
            dpre = dpre * (1.0 - p * p)
        st.index_add_(0, rows, torch.cat([
            ct.flatten(1), (ct * diff).flatten(1), dpre,
            (dpre[:, :, None] * dfeat[did][:, None, :]).flatten(1)],
            dim=1))
    return dx, st


def dense_gmm_bwd(db, g, beta, dfeat, alpha, feat, mu, isig, *,
                  use_tanh: bool, dense_dtype: str = "bfloat16"):
    """The hub block's share of the MoNet backward.

    Args:
      db: graph.structure.DenseBlock of the BACKWARD direction: rows are
        sources (row_ids), columns destinations (col_ids).
      g: [Nd, K, F] float32 gradient of the op's output; beta: [Nd, D],
        dfeat: [Nd, Dd] float32 destination tables (as bins.bin_gmm_node_bwd).
      alpha: [Ns, D], feat: [Ns, K, F] float32 source tables.
    Returns (dx [R, K, F], st [R, 2KD + D + D*Dd]) per block row: the stat
    row of ``bins.bin_gmm_node_bwd`` without its sfeat block (the caller
    multiplies the dpre columns by the rows' own sfeat).
    """
    _check_gmm_params("dense_gmm_bwd", mu, isig)
    if _on_cpu(g, beta, dfeat, alpha, feat, mu, isig, db.mask, db.row_ids,
               db.col_ids, db.chunk_ptr):
        return dense_gmm_bwd_plain(db, g, beta, dfeat, alpha, feat, mu, isig,
                                   use_tanh=use_tanh, dense_dtype=dense_dtype)
    _rounder(dense_dtype)
    Nd, K, F = g.shape
    Ns = feat.shape[0]
    D = mu.shape[1]
    if dfeat.dim() != 2:
        raise ValueError(f"dense_gmm_bwd: dfeat {tuple(dfeat.shape)} must "
                         "be 2-D")
    Dd = dfeat.shape[1]
    for key, t, shape in (("beta", beta, (Nd, D)), ("dfeat", dfeat, (Nd, Dd)),
                          ("alpha", alpha, (Ns, D)),
                          ("feat", feat, (Ns, K, F)), ("mu", mu, (K, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"dense_gmm_bwd: {key} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    _check_gmm("dense_gmm_bwd", K, D, F, Dd)
    _check_cuda("dense_gmm_bwd",
                dict(g=g, beta=beta, dfeat=dfeat, alpha=alpha, feat=feat,
                     mu=mu, isig=isig), {})
    _check_block("dense_gmm_bwd", db, K * F)
    R = db.row_ids.shape[0]
    dx = torch.empty((R, K, F), device=g.device, dtype=torch.float32)
    st = torch.empty((R, gmm_stat_width(K, D, Dd)), device=g.device,
                     dtype=torch.float32)
    lib = _build.load()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.dgnn_dense_gmm_bwd(
        _ptr(g), _ptr(beta), _ptr(dfeat), _ptr(alpha), _ptr(feat),
        _ptr(db.row_ids), _ptr(db.col_ids), _ptr(db.mask), _ptr(db.ct),
        _ptr(db.chunk_ptr), _ptr(mu), _ptr(isig), R, K, D, Dd, F,
        int(use_tanh), int(dense_dtype == "bfloat16"), _ptr(dx), _ptr(st),
        stream)
    if err:
        raise RuntimeError(f"dense_gmm_bwd kernel launch failed: CUDA error "
                           f"{err} (R={R}, K={K}, D={D}, Dd={Dd}, F={F})")
    LAUNCHES["dense_gmm_bwd"] += 1
    return dx, st
