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
only where the kernel is launched; a ``dense_gat_fwd`` call counts once,
its kernel's second launch with it, which walks again only the rows whose
largest score lies more than BOUND_GAP under the TPU kernel's bound); a
GAT launch given a table of global ids for the dropout hash (``gid``, as
ops/bins.py's) counts under its name with ``_gid`` appended.  The MoNet
kernels walk the block's work list where it has one (``gmm_work``;
graph.structure.WorkList: its long rows cut into pieces, a warp a piece; a
merge kernel, counted as ``dense_gmm_merge``, adds the cut rows' partials
after each such launch), else a warp a block row.
``dense_gat_fwd_instance``, ``dense_gat_bwd_instance``,
``dense_gmm_fwd_instance`` and
``dense_gmm_bwd_instance`` pick the template instance of each kernel that a
call launches; the launchers refuse any other.  Each launch asks the
recorder (utils/profiling.py ``probe_args``) for its row-span probe: the
flag word and a buffer of a span a warp's work item ([R, 2]; MoNet's with a
work list [pieces, 2]), or none.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from .. import native
from ..graph.hub import DENSE_CT, DENSE_RT
from ..graph.structure import WorkList, split_budget
from ..utils import profiling
from . import _build
from .bins import (NEG_B, _check_cuda, _check_gid, _check_gmm,
                   _check_gmm_params, _hash_ids, _inv_keep, _on_cpu, _opt,
                   _ptr, _seed_arg, gmm_stat_width)
from .common import gaussian_terms, leaky_relu, leaky_relu_grad, pair_keep

__all__ = ["dense_gat_fwd", "dense_gat_fwd_plain", "dense_gat_bwd",
           "dense_gat_bwd_plain", "dense_gmm_fwd", "dense_gmm_fwd_plain",
           "dense_gmm_bwd", "dense_gmm_bwd_plain", "unpack_mask", "LAUNCHES",
           "reset_launches", "DENSE_DTYPES", "MAX_HF", "dense_gat_fwd_instance",
           "dense_gat_bwd_instance", "dense_gmm_fwd_instance",
           "dense_gmm_bwd_instance", "GMM_FWD_MODEL", "GMM_BWD_MODEL",
           "gmm_work", "hold_work", "gmm_resident_warps"]

DENSE_DTYPES = ("bfloat16", "float32")
# int64 entries a block row of K5's row probe (csrc/dense_gat.cu
# kGatFwdProbe): its start and end, then its edges walked a second time and
# its edges (utils/profiling.py row_raises)
FWD_PROBE = 4
# The widest gap between a hub block row's bound (the TPU kernel's m) and its
# largest score at which K5 keeps its first walk, weighed at the bound: its
# largest term is then at least exp(-40), and a term that underflows lies
# e^-47 under it (csrc/dense_gat.cu kBoundGap, a constant there)
BOUND_GAP = 40.0
# Feature columns the kernels take: 32 lanes x at most 32 columns each.
MAX_HF = 1024

# (K, D) that dense_gmm_fwd's and (K, D, Dd) that dense_gmm_bwd's models'
# instances hold in registers (csrc/dense_gmm.cu); larger sizes take the
# general instance.
GMM_FWD_MODEL = (4, 2)
GMM_BWD_MODEL = (4, 2, 2)

LAUNCHES = {"dense_gat_fwd": 0, "dense_gat_bwd": 0,
            "dense_gmm_fwd": 0, "dense_gmm_bwd": 0,
            "dense_gat_fwd_gid": 0, "dense_gat_bwd_gid": 0,
            "dense_gmm_merge": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gmm_resident_warps(device) -> int:
    """The most warps that the MoNet hub-block kernels (the instances of
    the models' sizes at 8 columns a lane) keep resident on CUDA
    ``device``, by the occupancy calculator: what the work list's budget
    divides by (graph.structure.split_budget)."""
    lib = _build.load()
    warps = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.dgnn_dense_gmm_resident_warps(ctypes.byref(warps))
    if err:
        raise RuntimeError(f"dense_gmm occupancy query failed: CUDA error "
                           f"{err}")
    return warps.value


# id(block) -> the block's work list (None: a warp a block row), for as
# long as the block lives (``hold_work``)
_WORK: dict = {}


def hold_work(db, wl: WorkList | None) -> WorkList | None:
    """Hold ``wl`` as the work list that K7/K8 walk over block ``db`` for as
    long as ``db`` lives (None: a warp a block row); returns it."""
    _WORK[id(db)] = wl
    weakref.finalize(db, _WORK.pop, id(db), None)
    return wl


def gmm_work(db) -> WorkList | None:
    """The work list that K7/K8 walk over CUDA hub block ``db``, made at the
    block's first MoNet launch and held while the block lives: the tile
    rows' edges counted by the native library over the mask (copied to
    the host once), the budget from the block's edges and the warps the
    kernels keep resident on the card (graph.structure.split_budget).
    None where no row holds more edges than the budget.  The mask cannot
    be read while a CUDA graph is captured, so a block whose first launch
    is captured walks a warp a block row there: a capture is preceded by
    eager steps (StepGraph's ``warmup``) where the cut matters."""
    if id(db) in _WORK:
        return _WORK[id(db)]
    if torch.cuda.is_current_stream_capturing():
        return None
    dev = db.mask.device
    counts = native.tile_row_edges(db.mask.cpu().numpy())
    budget = split_budget(int(counts.sum()), gmm_resident_warps(dev))
    wl = WorkList.build(counts, db.chunk_ptr.cpu().numpy(), budget)
    return hold_work(db, None if wl is None else wl.to(dev))


def _work_args(db):
    """The launchers' work-list arguments for block ``db``: (list, pieces,
    work items, merge_rows, merge_ptr, cut rows); without a list, a warp a
    block row: (None, None, R, None, None, 0)."""
    wl = gmm_work(db)
    if wl is None:
        return None, None, db.row_ids.shape[0], None, None, 0
    return (wl, wl.pieces, wl.num_pieces, wl.merge_rows, wl.merge_ptr,
            wl.split_rows)


def dense_gat_fwd_instance(H: int, F: int) -> tuple[int, int]:
    """(heads held, feature columns a lane) of the csrc/dense_gat.cu
    forward instance for H heads of F features: 4 heads held up to H = 4,
    else 16; a warp a block row at every width (a group of 8 lanes a row at
    the output layer's 7 columns measured slower), the fewest columns a
    lane (a power of two) that cover H*F."""
    cols = 1
    while 32 * cols < H * F:
        cols *= 2
    return (4 if H <= 4 else 16), cols


def dense_gat_bwd_instance(H: int, F: int) -> tuple[int, int]:
    """(heads held, feature columns a lane) of the csrc/dense_gat.cu
    backward instance: the forward's rule (the two kernels share their
    instance set)."""
    return dense_gat_fwd_instance(H, F)


def _gmm_cols(KF: int) -> int:
    """1, 8 or 32 columns a lane of a warp, the fewest that cover K*F."""
    return next(c for c in (1, 8, 32) if 32 * c >= KF or c == 32)


def dense_gmm_fwd_instance(K: int, D: int, F: int) -> tuple[str, int]:
    """("model" or "general", feature columns a lane) of the
    csrc/dense_gmm.cu forward instance: the models' sizes where K and D fit
    GMM_FWD_MODEL, else the general limits; 1, 8 or 32 columns a lane."""
    fits = all(v <= m for v, m in zip((K, D), GMM_FWD_MODEL))
    return ("model" if fits else "general"), _gmm_cols(K * F)


def dense_gmm_bwd_instance(K: int, D: int, Dd: int,
                           F: int) -> tuple[str, int]:
    """("model" or "general", feature columns a lane) of the
    csrc/dense_gmm.cu backward instance: the models' stat sizes where K, D
    and Dd fit GMM_BWD_MODEL, else the general limits; 1, 8 or 32 columns
    a lane of a warp, the fewest that cover K*F."""
    fits = all(v <= m for v, m in zip((K, D, Dd), GMM_BWD_MODEL))
    return ("model" if fits else "general"), _gmm_cols(K * F)


def _probe(kernel: str, args, R: int, like: torch.Tensor, width: int = 2):
    """The recorder's (flag, buffer) for a launch of ``kernel`` over R work
    items, block rows or pieces (utils/profiling.py), named
    ``kernel<args>``: the instance as the ``*_instance`` picker gives it
    (GAT's template arguments; MoNet's "model" or "general" sizes and
    columns a lane); ``width`` entries an item (K5: 4, its two counts
    after the stamps)."""
    name = f"{kernel}<{', '.join(map(str, args))}>"
    return profiling.probe_args(name, R, like.device, width)


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
                        p: float = 0.0, seed=0,
                        dense_dtype: str = "bfloat16", gid=None):
    """Plain PyTorch hub-block forward; same arguments and outputs as
    ``dense_gat_fwd``.  m is each row's largest score (a scatter amax).
    As the kernel, a row whose m lies at most BOUND_GAP under its bound
    LeakyReLU(ar + max ac over all the block's columns) is weighed at the
    bound, bf16 rounding included, and restated at m; any other row is
    weighed at m."""
    rnd = _rounder(dense_dtype)
    H, F = feat.shape[1], feat.shape[2]
    rid_all = db.row_ids.long()
    cid_all = db.col_ids.long()
    R = rid_all.shape[0]
    new = dict(device=feat.device, dtype=torch.float32)

    def scores(rows, cols):
        s_raw = ar[rid_all[rows]] + ac[cid_all[cols]]      # [E, H]
        return s_raw, leaky_relu(s_raw, slope)

    m = torch.full((R, H), NEG_B, **new)
    for rows, cols in _tiles(db):
        m.scatter_reduce_(0, rows[:, None].expand(-1, H),
                          scores(rows, cols)[1], "amax")
    bound = leaky_relu(ar[rid_all] + _col_max(ac, db)[None, :], slope)
    again = ((m > NEG_B) & (bound - m > BOUND_GAP)).any(dim=1, keepdim=True)
    ref = torch.where(again, m, bound)
    scale = torch.where(again | (m <= NEG_B), 1.0, torch.exp(bound - m))
    l = torch.zeros((R, H), **new)
    acc = torch.zeros((R, H, F), **new)
    lpos = torch.zeros((R, H), **new) if with_pos else None
    accpos = torch.zeros((R, H, F), **new) if with_pos else None
    for rows, cols in _tiles(db):
        rid, cid = rid_all[rows], cid_all[cols]
        s_raw, s = scores(rows, cols)
        pw = torch.exp(s - ref[rows])
        pd = rnd(pw * pair_keep(seed, _hash_ids(rid, gid),
                                _hash_ids(cid, gid), H, p) if p > 0 else pw)
        # l sums the undropped p: bf16-rounded without dropout (the TPU
        # kernel's matmul ones column), float32 with it
        lw = (pw if p > 0 else pd) * scale[rows]
        pd = pd * scale[rows]
        x = rnd(feat[cid])                                 # [E, H, F]
        l.index_add_(0, rows, lw)
        acc.index_add_(0, rows, pd[..., None] * x)
        if with_pos:
            pos = s_raw >= 0
            lpos.index_add_(0, rows, torch.where(pos, lw, 0.0))
            accpos.index_add_(0, rows,
                              torch.where(pos, pd, 0.0)[..., None] * x)
    return m, l, lpos, acc, accpos


def _check_block(name, db, HF, H=None):
    T = db.mask.shape[0]
    R, C = db.row_ids.shape[0], db.col_ids.shape[0]
    if (db.mask.dtype != torch.uint8 or db.mask.dim() != 3
            or tuple(db.mask.shape[1:]) != (DENSE_RT, DENSE_CT // 8)):
        raise ValueError(f"{name}: mask must be uint8 [T, {DENSE_RT}, "
                         f"{DENSE_CT // 8}], got {db.mask.dtype} "
                         f"{tuple(db.mask.shape)}")
    if not db.mask.is_contiguous() or db.mask.data_ptr() % 8:
        raise ValueError(f"{name}: mask must be contiguous and 8-byte "
                         "aligned (the kernels read a tile row's words two "
                         "at a time)")
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
                  p: float = 0.0, seed=0,
                  dense_dtype: str = "bfloat16", gid=None):
    """The hub block's share of the GAT forward (pass A).

    Args:
      db: graph.structure.DenseBlock of the forward direction.
      ar: [Nr, H] float32 destination coefficients (indexed by row_ids).
      ac: [N, H] float32 source coefficients, feat: [N, H, F] float32
        source features (indexed by col_ids).
      p, seed: attention-dropout probability and uint32 seed (p = 0: off),
        hashed on the global ids (dst = row_ids[r], src = col_ids[c]); the
        seed as ops/bins.py's wrappers take it (an int, or a one-element
        integer tensor on the tables' device).
      dense_dtype: "bfloat16" or "float32" (module docstring).
      gid: None, or the int32 table of the ids the dropout hash takes
        (ops/bins.py), indexed by row_ids and col_ids.
    Returns (m, l, lpos, acc, accpos) per block row: m, l, lpos [R, H];
    acc, accpos [R, H, F]; lpos/accpos are None unless ``with_pos``.  m is
    the row's exact largest score, max LeakyReLU(ar + ac) over its edges,
    and the partials are relative to it; a row with no edge in the block
    has m = -1e30 (an empty segment), l = 0 and acc = 0.
    """
    if _on_cpu(ar, ac, feat, db.mask, db.row_ids, db.col_ids, db.chunk_ptr,
               *_opt(gid)):
        return dense_gat_fwd_plain(db, ar, ac, feat, slope=slope,
                                   with_pos=with_pos, p=p, seed=seed,
                                   dense_dtype=dense_dtype, gid=gid)
    _rounder(dense_dtype)
    N, H, F = feat.shape
    if ac.shape != (N, H) or ar.dim() != 2 or ar.shape[1] != H:
        raise ValueError(f"dense_gat_fwd: feat {tuple(feat.shape)}, ac "
                         f"{tuple(ac.shape)}, ar {tuple(ar.shape)}")
    _check_cuda("dense_gat_fwd", dict(feat=feat, ac=ac, ar=ar), {}, H)
    _check_block("dense_gat_fwd", db, H * F, H)
    _check_gid("dense_gat_fwd", gid, feat)
    R = db.row_ids.shape[0]
    acmax = _col_max(ac, db).contiguous()
    new = dict(device=feat.device, dtype=torch.float32)
    m = torch.empty((R, H), **new)
    l = torch.empty((R, H), **new)
    far = torch.empty(1, device=feat.device, dtype=torch.int32)
    acc = torch.empty((R, H, F), **new)
    lpos = torch.empty((R, H), **new) if with_pos else None
    accpos = torch.empty((R, H, F), **new) if with_pos else None
    hmax, cols = dense_gat_fwd_instance(H, F)
    seed_t = _seed_arg(seed, p, feat)
    lib = _build.load()
    flag, spans = _probe("dense_gat_fwd_kernel", (hmax, cols), R, feat,
                         FWD_PROBE)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = lib.dgnn_dense_gat_fwd(
        _ptr(feat), _ptr(ac), _ptr(ar), _ptr(acmax), _ptr(db.row_ids),
        _ptr(db.col_ids), _ptr(db.mask), _ptr(db.ct), _ptr(db.chunk_ptr),
        R, H, F, float(slope), int(with_pos), float(p), _inv_keep(p),
        _ptr(seed_t), _ptr(gid), int(dense_dtype == "bfloat16"),
        hmax, cols, _ptr(m), _ptr(l), _ptr(lpos), _ptr(acc), _ptr(accpos),
        _ptr(far), _ptr(flag), _ptr(spans), stream)
    if err:
        raise RuntimeError(f"dense_gat_fwd kernel launch failed: CUDA error "
                           f"{err} (R={R}, H={H}, F={F})")
    LAUNCHES["dense_gat_fwd" + ("_gid" if gid is not None else "")] += 1
    return m, l, lpos, acc, accpos


# ---------------------------------------------------------------------------
# Backward (pass B over the transposed block: rows = sources, cols = dsts)
# ---------------------------------------------------------------------------


def dense_gat_bwd_plain(db, g, ar, M, Linv, ws, ac, feat, *, slope: float,
                        p: float = 0.0, seed=0,
                        dense_dtype: str = "bfloat16", gid=None):
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
        ah = (a * pair_keep(seed, _hash_ids(did, gid), _hash_ids(sid, gid),
                            H, p) if p > 0 else a)
        gi = rnd(g[did])                                   # [E, H, F]
        dx.index_add_(0, rows, rnd(ah)[..., None] * gi)
        ge = (rnd(feat[sid]) * gi).sum(dim=-1)             # [E, H]
        u = (ah * ge - a * ws[did]) * leaky_relu_grad(s_raw, slope)
        dac.index_add_(0, rows, u)
    return dx, dac


def dense_gat_bwd(db, g, ar, M, Linv, ws, ac, feat, *, slope: float,
                  p: float = 0.0, seed=0,
                  dense_dtype: str = "bfloat16", gid=None):
    """The hub block's share of the GAT backward (pass B).

    Args:
      db: graph.structure.DenseBlock of the BACKWARD direction: rows are
        sources (row_ids), columns destinations (col_ids).
      g: [Nd, H, F] float32 gradient of the op's output (destinations).
      ar, M, Linv, ws: [Nd, H] float32 destination tables (as bins.bin_gat_bwd).
      ac: [Ns, H], feat: [Ns, H, F] float32 source tables.
      p, seed: attention dropout, hashed on the global ids (dst =
        col_ids[c], src = row_ids[r]), so the mask matches the forward's.
      gid: None, or the int32 table of the ids the dropout hash takes
        (ops/bins.py), indexed by row_ids and col_ids.
    Returns (dx [R, H, F], dac [R, H]) per block row:
      dx  = sum_c a^ g_c
      dac = sum_c (a^ <x, g_c> - a ws_c) * LeakyReLU'(ar_c + ac)
    """
    if _on_cpu(g, ar, M, Linv, ws, ac, feat, db.mask, db.row_ids,
               db.col_ids, db.chunk_ptr, *_opt(gid)):
        return dense_gat_bwd_plain(db, g, ar, M, Linv, ws, ac, feat,
                                   slope=slope, p=p, seed=seed,
                                   dense_dtype=dense_dtype, gid=gid)
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
    _check_gid("dense_gat_bwd", gid, g)
    R = db.row_ids.shape[0]
    dx = torch.empty((R, H, F), device=g.device, dtype=torch.float32)
    dac = torch.empty((R, H), device=g.device, dtype=torch.float32)
    hmax, cols = dense_gat_bwd_instance(H, F)
    seed_t = _seed_arg(seed, p, g)
    lib = _build.load()
    flag, spans = _probe("dense_gat_bwd_kernel", (hmax, cols), R, g)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.dgnn_dense_gat_bwd(
        _ptr(g), _ptr(ar), _ptr(M), _ptr(Linv), _ptr(ws), _ptr(ac),
        _ptr(feat), _ptr(db.row_ids), _ptr(db.col_ids), _ptr(db.mask),
        _ptr(db.ct), _ptr(db.chunk_ptr), R, H, F, float(slope), float(p),
        _inv_keep(p), _ptr(seed_t), _ptr(gid),
        int(dense_dtype == "bfloat16"), hmax, cols, _ptr(dx), _ptr(dac),
        _ptr(flag), _ptr(spans), stream)
    if err:
        raise RuntimeError(f"dense_gat_bwd kernel launch failed: CUDA error "
                           f"{err} (R={R}, H={H}, F={F})")
    LAUNCHES["dense_gat_bwd" + ("_gid" if gid is not None else "")] += 1
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
    new = dict(device=feat.device, dtype=torch.float32)
    acc = torch.empty((R, K, F), **new)
    wl, pieces, P, mrows, mptr, S = _work_args(db)
    part = None if wl is None else torch.empty((wl.slots, K * F), **new)
    sizes, cols = dense_gmm_fwd_instance(K, D, F)
    lib = _build.load()
    flag, spans = _probe("dense_gmm_fwd_kernel", (sizes, cols), P, feat)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = lib.dgnn_dense_gmm_fwd(
        _ptr(feat), _ptr(alpha), _ptr(beta), _ptr(db.row_ids),
        _ptr(db.col_ids), _ptr(db.mask), _ptr(db.ct), _ptr(db.chunk_ptr),
        _ptr(mu), _ptr(isig), R, K, D, F, int(use_tanh),
        int(dense_dtype == "bfloat16"), int(sizes == "general"), cols,
        _ptr(pieces), P, _ptr(mrows), _ptr(mptr), S, _ptr(acc), _ptr(part),
        _ptr(flag), _ptr(spans), stream)
    if err:
        raise RuntimeError(f"dense_gmm_fwd kernel launch failed: CUDA error "
                           f"{err} (R={R}, K={K}, D={D}, F={F}, P={P})")
    LAUNCHES["dense_gmm_fwd"] += 1
    LAUNCHES["dense_gmm_merge"] += int(wl is not None)
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
    new = dict(device=g.device, dtype=torch.float32)
    ns = gmm_stat_width(K, D, Dd)
    dx = torch.empty((R, K, F), **new)
    st = torch.empty((R, ns), **new)
    wl, pieces, P, mrows, mptr, S = _work_args(db)
    # a cut row's piece: its dx, then its stat row
    part = None if wl is None else torch.empty((wl.slots, K * F + ns), **new)
    sizes, cols = dense_gmm_bwd_instance(K, D, Dd, F)
    lib = _build.load()
    flag, spans = _probe("dense_gmm_bwd_kernel", (sizes, cols), P, g)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.dgnn_dense_gmm_bwd(
        _ptr(g), _ptr(beta), _ptr(dfeat), _ptr(alpha), _ptr(feat),
        _ptr(db.row_ids), _ptr(db.col_ids), _ptr(db.mask), _ptr(db.ct),
        _ptr(db.chunk_ptr), _ptr(mu), _ptr(isig), R, K, D, Dd, F,
        int(use_tanh), int(dense_dtype == "bfloat16"),
        int(sizes == "general"), cols, _ptr(pieces), P, _ptr(mrows),
        _ptr(mptr), S, _ptr(dx), _ptr(st), _ptr(part), _ptr(flag),
        _ptr(spans), stream)
    if err:
        raise RuntimeError(f"dense_gmm_bwd kernel launch failed: CUDA error "
                           f"{err} (R={R}, K={K}, D={D}, Dd={Dd}, F={F}, "
                           f"P={P})")
    LAUNCHES["dense_gmm_bwd"] += 1
    LAUNCHES["dense_gmm_merge"] += int(wl is not None)
    return dx, st
