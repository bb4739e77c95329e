"""Shared machinery for the fused graph ops (port of ``dgnn_tpu/ops/common.py``).

- slot masking for padded degree-binned tables,
- the stateless attention-dropout hash ``pair_keep``: the keep mask of an
  edge is re-derived from (seed, dst id, src id, head) by an integer hash,
  so the forward (CSR bins) and backward (CSC bins) passes agree bit for
  bit with no per-edge storage.  It is bit-identical to the JAX package's
  hash and to the one inside csrc/bin_gat.cu; ``edge_keep`` is the JAX
  package's hash of (seed, edge id, head).  The seed is a Python int or a
  one-element integer tensor on the ids' device (a seed drawn on the card
  inside a step that a CUDA graph replays, as the JAX package draws it
  inside its jitted step); ``seed_tensor`` gives the GAT kernels' form of
  it, a uint32 in device memory,
- the scatter-free segment merges ``combine_sum`` / ``combine_lse`` over a
  graph's combine table,
- the Gaussian kernel weights of the MoNet passes (``gaussian_terms``),
- the ops' ``gather_dtype``: ``gather_type`` reads it, ``rounded`` rounds a
  gathered scalar column with the feature rows.
"""

from __future__ import annotations

import torch

__all__ = [
    "EMPTY_M",
    "NEG_INF",
    "combine_lse",
    "check_seed",
    "combine_sum",
    "edge_keep",
    "gather_type",
    "gaussian_terms",
    "is_empty_m",
    "lane_mask",
    "leaky_relu",
    "leaky_relu_grad",
    "pair_keep",
    "rounded",
    "seed_tensor",
]

NEG_INF = float("-inf")

# Empty-segment sentinel threshold: the bin kernels emit a finite -1e30 as
# the maximum of an empty segment, so "is empty" guards treat anything at or
# below this as empty, not just -inf.  Real score maxima are sums of finite
# attention logits and never reach it.
EMPTY_M = -1e29

_M32 = 0xFFFFFFFF


def gather_type(gather_dtype) -> torch.dtype:
    """The storage type of the ops' gathered feature rows for a
    ``gather_dtype`` argument: None (or float32) keeps float32;
    ``torch.bfloat16`` (or "bfloat16") halves the rows.  Sums are float32
    either way."""
    if gather_dtype in (None, torch.float32, "float32"):
        return torch.float32
    if gather_dtype in (torch.bfloat16, "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"gather_dtype must be None, float32 or bfloat16, got "
                     f"{gather_dtype!r}")


def rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and held as float32: a scalar column that
    the JAX ops concatenate into the gathered rows, and so narrow with
    them.  The identity for float32."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def is_empty_m(m: torch.Tensor) -> torch.Tensor:
    """True where a per-segment max marks an empty segment (-inf or the bin
    kernels' finite -1e30 sentinel)."""
    return m <= EMPTY_M


def lane_mask(count: torch.Tensor, width: int) -> torch.Tensor:
    """[S] counts -> [S, width] bool validity mask."""
    lane = torch.arange(width, device=count.device, dtype=count.dtype)
    return lane[None, :] < count[:, None]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32.

    Torch has no full uint32 arithmetic, so the product is split at 16 bits
    of c: x * lo < 2^48 and x * hi < 2^48 both stay inside int64."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def edge_keep(seed: int, edge: torch.Tensor, num_heads: int,
              p: float) -> torch.Tensor:
    """Deterministic per-(edge, head) inverted-dropout keep mask.

    ``edge`` is an integer edge-id tensor (read as uint32), ``seed`` a
    uint32 Python int.  The result has shape edge.shape + (num_heads,) with
    values in {0, float32(1/(1-p))}; a slot is kept iff u > p, with

      u = (mix32((edge * H + h) ^ seed * 0x9E3779B9) >> 8) * 2^-24

    all in uint32 arithmetic, bit-identical to
    ``dgnn_tpu.ops.common.edge_keep``.
    """
    e = edge.to(torch.int64) & _M32
    h = torch.arange(num_heads, device=e.device, dtype=torch.int64)
    z = (e[..., None] * num_heads + h) & _M32
    z = _mix32(z ^ (((int(seed) & _M32) * 0x9E3779B9) & _M32))
    # z >> 8 < 2^24: exact in float32, as the JAX cast is
    u = (z >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.where(u > p, 1.0 / (1.0 - p), 0.0).to(torch.float32)


def check_seed(seed, device: torch.device) -> None:
    """Raises unless ``seed`` is a Python int or a one-element integer
    tensor on ``device``."""
    if not isinstance(seed, torch.Tensor):
        int(seed)  # a Python int, or raises
        return
    if (seed.dtype.is_floating_point or seed.dtype.is_complex
            or seed.dtype == torch.bool or seed.numel() != 1):
        raise TypeError(f"a dropout seed tensor holds one integer, got "
                        f"{seed.dtype} {tuple(seed.shape)}")
    if seed.device != device:
        raise ValueError(f"the dropout seed lies on {seed.device}, the ids "
                         f"on {device}")


def _seed_u32(seed, device: torch.device):
    """The seed's uint32 value: a Python int, or an int64 0-d tensor."""
    if not isinstance(seed, torch.Tensor):
        return int(seed) & _M32
    check_seed(seed, device)
    return seed.reshape(()).to(torch.int64) & _M32


def seed_tensor(seed, like: torch.Tensor) -> torch.Tensor:
    """The uint32 dropout seed as a 0-d int32 tensor on ``like``'s device
    holding its 32 bits: what the GAT kernels read through a ``const
    uint32_t*``.

    A Python int is written on the device by a fill (nothing is copied from
    the host).  A one-element integer tensor must lie on that device: an
    int32 one is read in place, a wider one through a view of its low
    32-bit word (CUDA devices are little-endian), so an element of a seed
    table drawn inside a captured step is what the kernels read on every
    replay."""
    if not isinstance(seed, torch.Tensor):
        s = int(seed) & _M32
        return torch.full((), s - (1 << 32) if s >> 31 else s,
                          dtype=torch.int32, device=like.device)
    check_seed(seed, like.device)
    if seed.dtype == torch.int32:
        return seed.reshape(())
    return seed.reshape(1).to(torch.int64).view(torch.int32)[0]


def pair_keep(seed, dst: torch.Tensor, src: torch.Tensor,
              num_heads: int, p: float) -> torch.Tensor:
    """Deterministic per-(dst, src, head) inverted-dropout keep mask.

    ``dst``/``src`` are broadcastable integer node-id tensors (read as
    uint32); ``seed`` is a Python int or a one-element integer tensor on
    the ids' device, read as uint32.  The result has shape
    broadcast(dst, src) + (num_heads,) with values in {0, float32(1/(1-p))};
    a slot is kept iff u > p, with

      base = mix32(dst * 0x9E3779B9 ^ mix32(src ^ seed * 0x85EBCA6B))
      u    = (mix32(base * H + h) >> 8) * 2^-24

    all in uint32 arithmetic, bit-identical to
    ``dgnn_tpu.ops.common.pair_keep``.
    """
    d = dst.to(torch.int64) & _M32
    s = src.to(torch.int64) & _M32
    seed_mix = _mul32(_seed_u32(seed, s.device), 0x85EBCA6B)
    base = _mix32(_mul32(d, 0x9E3779B9) ^ _mix32(s ^ seed_mix))
    h = torch.arange(num_heads, device=base.device, dtype=torch.int64)
    z = _mix32((base[..., None] * num_heads + h) & _M32)
    u = (z >> 8).to(torch.float32) * (1.0 / (1 << 24))
    # u > p compares in float32, as the JAX hash and the kernels do
    return torch.where(u > p, 1.0 / (1.0 - p), 0.0).to(torch.float32)


def _merge_sum(tbl, zcat, widths):
    """Masked K-way sum over gathered concatenated rows, split back per
    part."""
    s = None
    for j in range(tbl.shape[1]):
        tj = tbl[:, j].long()
        g = zcat[tj.clamp(min=0)]  # [R, C]
        g = torch.where((tj >= 0)[:, None], g, 0.0)
        s = g if s is None else s + g
    return list(torch.split(s, widths, dim=1))


def combine_sum(cmb, vals):
    """Scatter-free segment merge: out[r] = sum over row r's partials.

    ``cmb`` is a graph.CombineTable (positions into the concatenated
    per-segment partial rows).  The overflow rows (more partials than the
    capped Km) merge through the [V, K] side table and are patched in by
    row id.  ``vals``: one [S, ...] tensor or a list of them; returns the
    matching structure."""
    single = not isinstance(vals, (list, tuple))
    parts = [vals] if single else list(vals)
    shapes = [p.shape[1:] for p in parts]
    flat = [p.reshape(p.shape[0], -1) for p in parts]
    widths = [p.shape[1] for p in flat]
    zcat = torch.cat(flat, dim=1)
    outs = _merge_sum(cmb.main, zcat, widths)
    if cmb.ov_rows.shape[0]:
        outs_ov = _merge_sum(cmb.ov, zcat, widths)
        rows = cmb.ov_rows.long()
        outs = [o.index_put((rows,), ov) for o, ov in zip(outs, outs_ov)]
    outs = [o.reshape((o.shape[0],) + tuple(sh))
            for o, sh in zip(outs, shapes)]
    return outs[0] if single else outs


def _merge_lse(tbl, zcat, H, widths):
    """LSE-rescaled masked K-way sum over gathered concatenated rows
    ([m | parts...]); every part width is a multiple of H, so the
    exp(m - M) scale broadcasts by reshape."""
    R = tbl.shape[0]
    gs, ms = [], []
    for j in range(tbl.shape[1]):
        tj = tbl[:, j].long()
        g = zcat[tj.clamp(min=0)]  # [R, H + sum]
        gs.append(g)
        ms.append(torch.where((tj >= 0)[:, None], g[:, :H], NEG_INF))
    M = ms[0]
    for mj in ms[1:]:
        M = torch.maximum(M, mj)
    M0 = torch.where(is_empty_m(M), 0.0, M)
    scales = [torch.where(is_empty_m(mj), 0.0, torch.exp(mj - M0))
              for mj in ms]
    outs, off = [], H
    for w in widths:
        s = None
        for g, scale in zip(gs, scales):
            blk = g[:, off:off + w]
            if w == H:
                term = blk * scale
            else:
                term = (blk.reshape(R, H, w // H)
                        * scale[:, :, None]).reshape(R, w)
            s = term if s is None else s + term
        off += w
        outs.append(s)
    return M0, outs


def combine_lse(cmb, m: torch.Tensor, parts):
    """Log-sum-exp segment merge over combine-table positions.

    m: [S, H] per-segment maxima (-1e30 or -inf for empty segments).
    ``parts``: list of per-segment tensors ([S, H] or [S, H, F]) rescaled by
    exp(m - M_row) and summed per row.  Returns (M [N, H], merged parts)."""
    H = m.shape[-1]
    shapes = [p.shape[1:] for p in parts]
    flat = [p.reshape(p.shape[0], -1) for p in parts]
    widths = [p.shape[1] for p in flat]
    zcat = torch.cat([m] + flat, dim=1)
    M0, outs = _merge_lse(cmb.main, zcat, H, widths)
    if cmb.ov_rows.shape[0]:
        M_ov, outs_ov = _merge_lse(cmb.ov, zcat, H, widths)
        rows = cmb.ov_rows.long()
        M0 = M0.index_put((rows,), M_ov)
        outs = [o.index_put((rows,), ov) for o, ov in zip(outs, outs_ov)]
    outs = [o.reshape((o.shape[0],) + tuple(sh))
            for o, sh in zip(outs, shapes)]
    return M0, outs


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def leaky_relu_grad(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, slope).to(torch.float32)


def gaussian_terms(pseudo: torch.Tensor, mu: torch.Tensor,
                   inv_sigma: torch.Tensor):
    """[..., D] coordinates, [K, D] means and inverse widths ->
    (diff, t, w): diff = pseudo - mu and t = diff * inv_sigma, both
    [..., K, D], and the Gaussian kernel weights
    w = exp(-0.5 * sum_d t^2) [..., K]."""
    diff = pseudo[..., None, :] - mu
    t = diff * inv_sigma
    return diff, t, torch.exp(-0.5 * (t * t).sum(dim=-1))
