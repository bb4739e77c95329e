"""Dense hub-block path: the port's host build and plain versions against
the JAX package's (Pallas in interpret mode off-TPU), the op on cora against
the JAX op, a forced block against the all-binned build, and, on a CUDA
device, the port's kernels against their plain versions.

JAX is imported inside the JAX tests only, so that the CUDA tests run on a
machine without JAX:  python -m pytest --noconftest -m cuda
tests/test_torch_dense.py
"""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import dataclasses
import gc

import numpy as np
import pytest
import torch

from dgnn_tpu_torch import native
from dgnn_tpu_torch.data import synthetic
from dgnn_tpu_torch.graph import hub, structure
from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.ops import dense
from dgnn_tpu_torch.ops.gat import gat_aggregate

SLOPE = 0.2
SEED = 2 ** 31 + 12345  # a uint32 seed above the int32 range
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # as tests/test_torch_gat_op.py
# One hub-block row sums up to thousands of terms (a bin segment at most
# 128), and the Pallas reference sums them through XLA's dot, whose order
# varies from run to run: its float32 l reaches ~1e-5 relative off ours.
BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 mode on both sides rounds the same operands the same way, so nearly
# every element agrees to float32 summation order (BF16_TOL).  But XLA's and
# torch's exp, and the two packages' merges of M and L, may differ by an
# ulp, which can move a weight across a bf16 rounding boundary and change
# that one term by 2^-8 of itself (up to ~1e-2 for unit-scale data).  So at
# most BF16_FLIPS of the elements may leave BF16_TOL, and none may leave
# BF16_BOUND, the bf16-vs-float32 tolerance of tests/test_dense_block.py.
BF16_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_FLIPS = 1e-3
BF16_BOUND = dict(rtol=2e-2, atol=2e-2)
# Multi-tile forced block: 2 row chunks x 2 column tiles, with padded rows
# (300 of 512 real) and padded columns (2100 of 4096 real).
MULTI = dict(n=2400, r=300, c=2100)
# The same forced block over edges skewed on both sides (hub_edges), so
# that both directions' blocks hold hub rows: up to about 1,400 set columns
# in one tile row (many batches of a row list), rows with edges in both
# column tiles of their chunk, and real row EMPTIED_ROW cleared.
HUB = dict(n=2400, r=300, c=2100)
EMPTIED_ROW = 7


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _assert_close(got, want, dense_dtype, tol, err_msg=""):
    """float32: every element within ``tol``; bfloat16: see BF16_TOL."""
    got, want = np.asarray(got), np.asarray(want)
    if dense_dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=err_msg, **tol)
        return
    np.testing.assert_allclose(got, want, err_msg=err_msg, **BF16_BOUND)
    off = ~np.isclose(got, want, **BF16_TOL)
    assert off.mean() <= BF16_FLIPS, (err_msg, int(off.sum()), off.size)


def _edges(rng, n, avg_degree, power_law=True):
    """Deduplicated random COO edges with Zipf-skewed destinations."""
    e = int(n * avg_degree)
    src = rng.integers(0, n, e)
    dst = (np.minimum(rng.zipf(1.6, e) - 1, n - 1) if power_law
           else rng.integers(0, n, e))
    uniq = np.unique(np.stack([src, dst], 1), axis=0)
    return uniq[:, 0], uniq[:, 1]


def _tables(rng, n, h, f):
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return dict(ar=t(n, h), ac=t(n, h), feat=t(n, h, f), g=t(n, h, f),
                ws=t(n, h), M=t(n, h) + 2.0,
                Linv=torch.from_numpy(
                    rng.uniform(0.1, 1.0, (n, h)).astype(np.float32)))


def _multi_graph(rng):
    src, dst = _edges(rng, MULTI["n"], 4)
    return src, dst, build_graph(src, dst, MULTI["n"],
                                 dense=(MULTI["r"], MULTI["c"]))


# ---------------------------------------------------------------------------
# (a), (b): mask packing and the block build, array for array
# ---------------------------------------------------------------------------


def test_pack_and_unpack_mask_match_jax(rng):
    import jax.numpy as jnp

    from dgnn_tpu.graph import hub as jhub
    from dgnn_tpu.ops.pallas_dense import unpack_mask as jax_unpack

    mask01 = rng.random((8, 2 * hub.DENSE_CT)) < 0.1
    bits = hub.pack_mask_bits(mask01)
    np.testing.assert_array_equal(bits, jhub.pack_mask_bits(mask01))
    cb = hub.DENSE_CT // 8
    for t in range(2):
        tile = bits[:, t * cb:(t + 1) * cb]
        got = dense.unpack_mask(torch.from_numpy(tile)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_unpack(
            jnp.asarray(tile))))
        np.testing.assert_array_equal(
            got, mask01[:, t * hub.DENSE_CT:(t + 1) * hub.DENSE_CT])


@pytest.mark.parametrize("n,r,c", [(300, 40, 100),
                                   (MULTI["n"], MULTI["r"], MULTI["c"])])
def test_build_dense_numpy_matches_jax(rng, n, r, c):
    from dgnn_tpu.graph import hub as jhub
    from dgnn_tpu_torch.graph import build as tbuild

    src, dst = _edges(rng, n, 4)
    rp, ci = tbuild.coo_to_csr(src, dst, n)
    cp, _, _ = tbuild.csr_to_csc_permute(rp, ci)
    rows = np.argsort(np.diff(rp), kind="stable")[::-1][:r]
    cols = np.argsort(np.diff(cp), kind="stable")[::-1][:c]
    ours = hub.build_dense_numpy(rp, ci, rows, cols)
    theirs = jhub.build_dense_numpy(rp, ci, rows, cols)
    for key in ("row_ids", "col_ids", "mask", "rc", "ct", "first"):
        np.testing.assert_array_equal(getattr(ours[0], key),
                                      getattr(theirs[0], key), err_msg=key)
    assert ours[0].num_rows == theirs[0].num_rows == min(r, n)
    for x, y in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(x, y)
    if n > hub.DENSE_CT:
        assert len(ours[0].rc) == 4 and ours[0].first.tolist() == [1, 0, 1, 0]


# ---------------------------------------------------------------------------
# (c): plain versions against the Pallas kernels, multi-tile block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def multi_pair():
    """The multi-tile forced block built by both packages, and tables."""
    from dgnn_tpu.graph.structure import build_graph as jax_build_graph

    rng = np.random.default_rng(1)
    src, dst, tg = _multi_graph(rng)
    jg = jax_build_graph(src, dst, MULTI["n"],
                         dense=(MULTI["r"], MULTI["c"]))
    return jg, tg, _tables(rng, MULTI["n"], 2, 5)


def _jax_dt(dense_dtype):
    import jax.numpy as jnp

    return jnp.float32 if dense_dtype == "float32" else jnp.bfloat16


def _at_jax_max(part, m, m_jax):
    """A forward partial ([R, H] or [R, H, F]) relative to the port's m,
    the row's exact maximum, restated relative to the Pallas kernel's
    m_jax, its row bound (m <= m_jax): times exp(m - m_jax), flattened
    as the Pallas kernel returns it."""
    m = np.asarray(m, np.float64)
    scale = np.exp(m - np.asarray(m_jax, np.float64))
    part = np.asarray(part, np.float64)
    if part.ndim == 3:
        scale = scale[..., None]
    return (part * scale).reshape(part.shape[0], -1).astype(np.float32)


def _hold_to_jax(got, want, dense_dtype, tol):
    """The port's forward partials (m, l, lpos, acc, accpos) against the
    Pallas kernel's: m at or under its bound, and every partial restated
    at that bound within ``tol``."""
    m, m_jax = got[0].numpy(), np.asarray(want[0])
    assert (m <= m_jax).all()
    for name, w, g in zip(("l", "lpos", "acc", "accpos"), want[1:], got[1:]):
        if w is None:
            assert g is None, name
            continue
        _assert_close(_at_jax_max(g, m, m_jax), w, dense_dtype, tol, name)


@pytest.mark.parametrize("with_pos", [True, False])
@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("dense_dtype", ["float32", "bfloat16"])
def test_fwd_plain_matches_jax_kernel(multi_pair, with_pos, p, dense_dtype):
    import jax.numpy as jnp

    from dgnn_tpu.ops.pallas_dense import dense_gat_fwd as jax_fwd

    jg, tg, tb = multi_pair
    db = jg.fwd.dense
    n, h, f = tb["feat"].shape
    drop = (p, jnp.uint32(SEED), db.row_ids, db.col_ids) if p > 0 else None
    want = jax_fwd(db, jnp.asarray(tb["ar"].numpy())[db.row_ids],
                   jnp.asarray(tb["ac"].numpy())[db.col_ids],
                   jnp.asarray(tb["feat"].numpy().reshape(n, -1))[db.col_ids],
                   slope=SLOPE, with_pos=with_pos,
                   mat_dtype=_jax_dt(dense_dtype), drop=drop, interpret=True)
    args = (tg.fwd.dense, tb["ar"], tb["ac"], tb["feat"])
    kw = dict(slope=SLOPE, with_pos=with_pos, p=p, seed=SEED,
              dense_dtype=dense_dtype)
    got = dense.dense_gat_fwd_plain(*args, **kw)
    via_wrapper = dense.dense_gat_fwd(*args, **kw)  # CPU: the plain version
    _hold_to_jax(got, want, dense_dtype, BLOCK_TOL)
    for name, g, v in zip(("m", "l", "lpos", "acc", "accpos"), got,
                          via_wrapper):
        if g is None:
            assert v is None, name
            continue
        g = g.reshape(g.shape[0], -1).numpy()
        # the wrapper's CPU call against a second plain call: the same
        # terms, but the CPU index_add_ may sum a hub row's terms in
        # another order from one call to the next (under load), so float32
        # summation order (BLOCK_TOL, in both dense dtypes: the bf16 mode
        # rounds the same operands on both calls and sums in float32)
        np.testing.assert_allclose(v.reshape(v.shape[0], -1).numpy(), g,
                                   err_msg=name, **BLOCK_TOL)
    # padded rows are finite
    assert all(torch.isfinite(x).all() for x in got if x is not None)


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("dense_dtype", ["float32", "bfloat16"])
def test_bwd_plain_matches_jax_kernel(multi_pair, p, dense_dtype):
    import jax.numpy as jnp

    from dgnn_tpu.ops.pallas_dense import dense_gat_bwd as jax_bwd

    jg, tg, tb = multi_pair
    db = jg.bwd.dense
    n, h, f = tb["feat"].shape
    cid = np.asarray(db.col_ids)
    st = np.concatenate([tb[k].numpy() for k in ("ar", "M", "Linv", "ws")],
                        axis=1)[cid]
    drop = (p, jnp.uint32(SEED), db.row_ids, db.col_ids) if p > 0 else None
    want = jax_bwd(db, jnp.asarray(tb["ac"].numpy())[db.row_ids],
                   jnp.asarray(tb["feat"].numpy().reshape(n, -1))[db.row_ids],
                   jnp.asarray(tb["g"].numpy().reshape(n, -1)[cid]),
                   jnp.asarray(st), slope=SLOPE, H=h,
                   mat_dtype=_jax_dt(dense_dtype), drop=drop, interpret=True)
    got = dense.dense_gat_bwd(
        tg.bwd.dense, *(tb[k] for k in ("g", "ar", "M", "Linv", "ws", "ac",
                                        "feat")),
        slope=SLOPE, p=p, seed=SEED, dense_dtype=dense_dtype)
    for name, g, w in zip(("dx", "dac"), got, want):
        _assert_close(g.reshape(g.shape[0], -1).numpy(), w, dense_dtype,
                      BLOCK_TOL, name)


# ---------------------------------------------------------------------------
# (c'): the plain versions against the Pallas kernels on the block shapes
# the kernels' row lists must get right
# ---------------------------------------------------------------------------


def hub_edges(rng, n):
    """Deduplicated COO edges skewed on both sides: Zipf destinations from
    uniform sources, and Zipf sources (other nodes) to uniform
    destinations."""
    e = 2 * n
    zipf = lambda: np.minimum(rng.zipf(1.6, e) - 1, n - 1)  # noqa: E731
    into = np.stack([rng.integers(0, n, e), zipf()], 1)
    out_of = np.stack([rng.permutation(n)[zipf()], rng.integers(0, n, e)], 1)
    uniq = np.unique(np.concatenate([into, out_of]), axis=0)
    return uniq[:, 0], uniq[:, 1]


def tile_row_edges(db):
    """[T, RT] set columns of each tile row of a port DenseBlock."""
    return torch.stack([dense.unpack_mask(db.mask[t]).sum(dim=1)
                        for t in range(db.mask.shape[0])])


def hub_block(db):
    """A port DenseBlock with real row EMPTIED_ROW cleared in every tile of
    its chunk.  Checks that the block has the shapes a row list must get
    right: two column tiles a row chunk, a tile row of more than 64 set
    columns (more than two batches of 32), a row with edges in two tiles,
    and a real row with none."""
    mask = db.mask.numpy().copy()
    rc = db.rc.numpy()
    mask[rc == EMPTIED_ROW // hub.DENSE_RT, EMPTIED_ROW % hub.DENSE_RT] = 0
    db = dataclasses.replace(db, mask=torch.from_numpy(mask))
    per = tile_row_edges(db)
    assert (torch.diff(db.chunk_ptr) >= 2).all()
    assert int(per.max()) > 64
    assert any(((per[a:b] > 0).sum(dim=0) >= 2).any()
               for a, b in zip(db.chunk_ptr[:-1].tolist(),
                               db.chunk_ptr[1:].tolist()))
    rows = per[rc == EMPTIED_ROW // hub.DENSE_RT]
    assert EMPTIED_ROW < db.num_rows and int(rows.sum()) > 0
    assert int(rows[:, EMPTIED_ROW % hub.DENSE_RT].sum()) == 0
    return db


def hub_graph(rng):
    """The port's graph over hub_edges with the forced HUB block."""
    src, dst = hub_edges(rng, HUB["n"])
    return build_graph(src, dst, HUB["n"], dense=(HUB["r"], HUB["c"]))


def hub_tol(db, tol):
    """``tol`` with its atol grown with the block's widest row, in units of
    128 terms (a bin segment's most): a hub row sums up to about 1,400
    unit-sized terms, in an order that the plain version's index_add_ does
    not fix from run to run."""
    widest = int(tile_row_edges(db).max())
    return dict(tol, atol=tol["atol"] * max(1.0, widest / 128))


@pytest.fixture(scope="module")
def hub_pair():
    """Both directions' hub blocks, built by both packages from one host
    graph, EMPTIED_ROW cleared in both ({"fwd": (port, jax), "bwd": ...}),
    and tables."""
    import jax.numpy as jnp

    from dgnn_tpu.graph.structure import build_graph as jax_build_graph

    rng = np.random.default_rng(3)
    src, dst = hub_edges(rng, HUB["n"])
    block = (HUB["r"], HUB["c"])
    tg = build_graph(src, dst, HUB["n"], dense=block)
    jg = jax_build_graph(src, dst, HUB["n"], dense=block)
    blocks = {}
    for d in ("fwd", "bwd"):
        t, j = getattr(tg, d).dense, getattr(jg, d).dense
        np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
        t = hub_block(t)
        blocks[d] = (t, dataclasses.replace(j, mask=jnp.asarray(t.mask)))
    return blocks, _tables(rng, HUB["n"], 2, 5)


@pytest.mark.parametrize("with_pos", [True, False])
@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("dense_dtype", ["float32", "bfloat16"])
def test_fwd_plain_matches_jax_kernel_on_hub_rows(hub_pair, with_pos, p,
                                                 dense_dtype):
    import jax.numpy as jnp

    from dgnn_tpu.ops.pallas_dense import dense_gat_fwd as jax_fwd

    blocks, tb = hub_pair
    db, jdb = blocks["fwd"]
    n = tb["feat"].shape[0]
    drop = (p, jnp.uint32(SEED), jdb.row_ids, jdb.col_ids) if p > 0 else None
    want = jax_fwd(jdb, jnp.asarray(tb["ar"].numpy())[jdb.row_ids],
                   jnp.asarray(tb["ac"].numpy())[jdb.col_ids],
                   jnp.asarray(tb["feat"].numpy().reshape(n, -1))[jdb.col_ids],
                   slope=SLOPE, with_pos=with_pos,
                   mat_dtype=_jax_dt(dense_dtype), drop=drop, interpret=True)
    got = dense.dense_gat_fwd(db, tb["ar"], tb["ac"], tb["feat"], slope=SLOPE,
                              with_pos=with_pos, p=p, seed=SEED,
                              dense_dtype=dense_dtype)
    _hold_to_jax(got, want, dense_dtype, BLOCK_TOL)
    # the emptied row: no partials
    for t in (got[1], got[3]) + ((got[2], got[4]) if with_pos else ()):
        assert not t[EMPTIED_ROW].any()


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("dense_dtype", ["float32", "bfloat16"])
def test_bwd_plain_matches_jax_kernel_on_hub_rows(hub_pair, p, dense_dtype):
    import jax.numpy as jnp

    from dgnn_tpu.ops.pallas_dense import dense_gat_bwd as jax_bwd

    blocks, tb = hub_pair
    db, jdb = blocks["bwd"]
    n, h, f = tb["feat"].shape
    cid = np.asarray(jdb.col_ids)
    st = np.concatenate([tb[k].numpy() for k in ("ar", "M", "Linv", "ws")],
                        axis=1)[cid]
    drop = (p, jnp.uint32(SEED), jdb.row_ids, jdb.col_ids) if p > 0 else None
    want = jax_bwd(jdb, jnp.asarray(tb["ac"].numpy())[jdb.row_ids],
                   jnp.asarray(tb["feat"].numpy().reshape(n, -1))[jdb.row_ids],
                   jnp.asarray(tb["g"].numpy().reshape(n, -1)[cid]),
                   jnp.asarray(st), slope=SLOPE, H=h,
                   mat_dtype=_jax_dt(dense_dtype), drop=drop, interpret=True)
    got = dense.dense_gat_bwd(
        db, *(tb[k] for k in ("g", "ar", "M", "Linv", "ws", "ac", "feat")),
        slope=SLOPE, p=p, seed=SEED, dense_dtype=dense_dtype)
    tol = hub_tol(db, BLOCK_TOL)
    for name, g, w in zip(("dx", "dac"), got, want):
        _assert_close(g.reshape(g.shape[0], -1).numpy(), w, dense_dtype, tol,
                      name)
        # the emptied row: no partials
        assert not g[EMPTIED_ROW].any(), name


@pytest.mark.parametrize("hf,want", [
    ((4, 64), (4, 8)),     # the hidden layer: 8 columns a lane
    ((1, 7), (4, 1)),      # the output layer: a warp a row all the same
    ((3, 5), (4, 1)),
    ((4, 8), (4, 1)),      # 32 columns: one a lane
    ((8, 16), (16, 4)),    # more than 4 heads: 16 held
    ((16, 64), (16, 32)),  # the widest row a warp takes
], ids=["4x64", "1x7", "3x5", "4x8", "8x16", "16x64"])
def test_gat_fwd_instance_choice(hf, want):
    """The forward's template instance (heads held, columns a lane) for the
    shapes the models and the tests launch; every instance takes a warp a
    block row."""
    assert dense.dense_gat_fwd_instance(*hf) == want


@pytest.mark.parametrize("kdf,want", [
    ((3, 2, 1, 64), ("model", 8)),    # cora MoNet's hidden layer
    ((3, 2, 1, 7), ("model", 1)),     # its output layer
    ((4, 2, 2, 256), ("model", 32)),  # the models' limits, 1024 columns
    ((8, 4, 4, 16), ("general", 8)),
    ((5, 2, 1, 8), ("general", 8)),   # K over the models' instance
    ((3, 3, 1, 8), ("general", 1)),   # D over it
    ((3, 2, 3, 8), ("general", 1)),   # Dd over it
], ids=["3x64", "3x7", "4x256", "8x16", "K5", "D3", "Dd3"])
def test_gmm_bwd_instance_choice(kdf, want):
    """The MoNet backward's template instance: the models' stat sizes
    (GMM_BWD_MODEL) or the general ones, and columns a lane."""
    assert dense.dense_gmm_bwd_instance(*kdf) == want


@pytest.mark.parametrize("hf,want", [
    ((4, 64), (4, 8)),     # the hidden layer: 8 columns a lane
    ((1, 7), (4, 1)),      # the output layer
    ((3, 5), (4, 1)),
    ((4, 8), (4, 1)),      # 32 columns: one a lane
    ((8, 16), (16, 4)),    # more than 4 heads: 16 held
    ((16, 64), (16, 32)),  # the widest row a warp takes
], ids=["4x64", "1x7", "3x5", "4x8", "8x16", "16x64"])
def test_gat_bwd_instance_choice(hf, want):
    """The backward's template instance (heads held, columns a lane): the
    forward's for every shape, the two kernels sharing their instances."""
    assert dense.dense_gat_bwd_instance(*hf) == want
    assert dense.dense_gat_bwd_instance(*hf) == dense.dense_gat_fwd_instance(
        *hf)


@pytest.mark.parametrize("kdf,want", [
    ((3, 2, 64), ("model", 8)),    # cora MoNet's hidden layer
    ((3, 2, 7), ("model", 1)),     # its output layer
    ((4, 2, 256), ("model", 32)),  # the models' limits, 1024 columns
    ((8, 4, 16), ("general", 8)),
    ((5, 2, 8), ("general", 8)),   # K over the models' instance
    ((3, 3, 8), ("general", 1)),   # D over it
    ((1, 1, 33), ("model", 8)),    # one column over a lane's one
], ids=["3x64", "3x7", "4x256", "8x16", "K5", "D3", "33"])
def test_gmm_fwd_instance_choice(kdf, want):
    """The MoNet forward's template instance: the models' sizes
    (GMM_FWD_MODEL) or the general ones, and columns a lane."""
    assert dense.dense_gmm_fwd_instance(*kdf) == want


# ---------------------------------------------------------------------------
# (d): gat_aggregate on cora against the JAX op
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cora_pair():
    from dgnn_tpu.graph.structure import build_graph as jax_build_graph

    d = synthetic.synthetic_citation("cora")
    tg = build_graph(d.src, d.dst, d.num_nodes, dense="auto")
    jg = jax_build_graph(d.src, d.dst, d.num_nodes, dense="auto")
    assert tg.fwd.dense is not None and tg.bwd.dense is not None
    return jg, tg, d.num_nodes


@pytest.mark.parametrize("h,f,dense_dtype,p", [
    (2, 8, "float32", 0.0),
    (2, 8, "float32", 0.3),
    (4, 64, "bfloat16", 0.3),   # the bench width, the model's default dtype
])
def test_cora_op_matches_jax(cora_pair, h, f, dense_dtype, p):
    import jax
    import jax.numpy as jnp

    from dgnn_tpu.ops.gat import gat_aggregate as jax_gat

    jg, tg, n = cora_pair
    rng = np.random.default_rng(h * 100 + f)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((n, h), (n, h), (n, h, f))]
    ct = rng.normal(size=(n, h, f)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    seed = int(jax.random.bits(key, dtype=jnp.uint32))

    @jax.jit
    def out_and_grads(g, ar, ac, feat, ct):
        out, vjp = jax.vjp(
            lambda *a: jax_gat(g, *a, attn_drop=p, key=key, training=True,
                               dense_dtype=dense_dtype), ar, ac, feat)
        return out, vjp(ct)

    out_j, grads_j = out_and_grads(jg, *map(jnp.asarray, arrs),
                                   jnp.asarray(ct))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out_t = gat_aggregate(tg, *ts, attn_drop=p, seed=seed, training=True,
                          dense_dtype=dense_dtype)
    out_t.backward(torch.from_numpy(ct))
    _assert_close(out_t.detach().numpy(), out_j, dense_dtype, FWD_TOL, "out")
    for name, t, gj in zip(("ar", "ac", "feat"), ts, grads_j):
        _assert_close(t.grad.numpy(), gj, dense_dtype, GRAD_TOL, name)


def test_cora_inference_matches_jax(cora_pair):
    """No input needs a gradient: the primal-only path (no sign-split) at
    the default bf16."""
    import jax
    import jax.numpy as jnp

    from dgnn_tpu.ops.gat import gat_aggregate as jax_gat

    jg, tg, n = cora_pair
    rng = np.random.default_rng(5)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((n, 1), (n, 1), (n, 1, 7))]
    out_j = jax.jit(jax_gat)(jg, *map(jnp.asarray, arrs))
    out_t = gat_aggregate(tg, *map(torch.from_numpy, arrs))
    _assert_close(out_t.numpy(), out_j, "bfloat16", FWD_TOL, "out")


# ---------------------------------------------------------------------------
# (e): a forced block against the all-binned build, in the port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_forced_block_matches_binned(rng, p):
    src, dst, g_dense = _multi_graph(rng)
    g_plain = build_graph(src, dst, MULTI["n"])
    assert g_dense.fwd.dense is not None and g_plain.fwd.dense is None
    assert g_dense.fwd.num_edges < g_plain.fwd.num_edges
    tb = _tables(rng, MULTI["n"], 2, 4)
    res = []
    for g in (g_dense, g_plain):
        ins = [tb[k].clone().requires_grad_(True)
               for k in ("ar", "ac", "feat")]
        out = gat_aggregate(g, *ins, attn_drop=p, seed=SEED, training=True,
                            dense_dtype="float32")
        torch.sin(out).sum().backward()
        res.append([out.detach()] + [t.grad for t in ins])
    torch.testing.assert_close(res[0][0], res[1][0], rtol=1e-4, atol=1e-5)
    for a, b in zip(res[0][1:], res[1][1:]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-4)


def test_refusals(rng):
    _, _, g = _multi_graph(rng)
    tb = _tables(rng, MULTI["n"], 2, 4)
    with pytest.raises(ValueError, match="dense_dtype"):
        gat_aggregate(g, tb["ar"], tb["ac"], tb["feat"], dense_dtype="fp16")
    with pytest.raises(ValueError, match="devices"):
        dense.dense_gat_fwd(g.fwd.dense, tb["ar"].to("meta"), tb["ac"],
                            tb["feat"], slope=SLOPE, with_pos=True)


# ---------------------------------------------------------------------------
# (e2): the MoNet kernels' work list, as a pure function of the tile rows'
# edges
# ---------------------------------------------------------------------------


def _counts(rng, chunks, entries, long_rows):
    """[T, RT] edges of each (entry, tile row) for ``chunks`` row chunks of
    ``entries`` schedule entries each (a list), up to 2,048 a tile row, and
    chunk_ptr; ``long_rows`` rows of the first chunk hold many edges in
    every entry, as a hub block's first rows do."""
    cp = np.concatenate([[0], np.cumsum(entries)])
    counts = rng.integers(0, 5, (int(cp[-1]), hub.DENSE_RT))
    counts[:entries[0], :long_rows] = rng.integers(
        900, hub.DENSE_CT + 1, (entries[0], long_rows))
    counts[rng.random(counts.shape) < 0.3] = 0
    return counts.astype(np.int32), cp.astype(np.int32)


@pytest.mark.parametrize("entries,long_rows,budget", [
    ([12, 3, 1], 5, 4096),        # rows of ~17k edges cut into ~5 pieces
    ([12, 3, 1], 5, 2048),        # the floor: a piece ~ one entry
    ([7, 7], 40, 1500),           # under a tile row's most: lone entries
    ([30, 1, 2, 1], 1, 10 ** 6),  # nothing over the budget: a piece a row
], ids=["4096", "2048", "1500", "none"])
def test_work_list_covers_each_row_once_in_launch_order(rng, entries,
                                                        long_rows, budget):
    counts, cp = _counts(rng, len(entries), entries, long_rows)
    pieces, rows, ptr = structure.work_list(counts, cp, budget)
    R = (len(cp) - 1) * hub.DENSE_RT
    assert pieces.dtype == rows.dtype == ptr.dtype == np.int32
    # launch order is row order; every row's pieces tile its chunk's
    # entries once, in order
    assert (np.diff(pieces[:, 0]) >= 0).all()
    assert np.array_equal(np.unique(pieces[:, 0]), np.arange(R))
    for r in range(R):
        mine = pieces[pieces[:, 0] == r]
        c = r // hub.DENSE_RT
        assert mine[0, 1] == cp[c] and mine[-1, 2] == cp[c + 1], r
        assert (mine[1:, 1] == mine[:-1, 2]).all() and (
            mine[:, 2] > mine[:, 1]).all(), r
        edges = [int(counts[a:b, r % hub.DENSE_RT].sum())
                 for _, a, b, _ in mine]
        # no piece over the budget unless it is one entry
        assert all(e <= budget or b - a == 1
                   for e, (_, a, b, _) in zip(edges, mine)), (r, edges)
        if len(mine) == 1:
            assert mine[0, 3] == -1
        else:  # a cut row: never cut where the budget held the whole row
            assert sum(edges) > budget
    # the cut rows, in order, and their pieces' slots numbered in launch
    # order
    cut = pieces[pieces[:, 3] >= 0]
    assert np.array_equal(cut[:, 3], np.arange(len(cut)))
    assert np.array_equal(rows, np.unique(cut[:, 0]))
    assert ptr[0] == 0 and ptr[-1] == len(cut)
    for i, r in enumerate(rows):
        assert (cut[ptr[i]:ptr[i + 1], 0] == r).all()
    if budget >= 10 ** 6:
        assert len(rows) == 0 and len(pieces) == R
    else:
        assert len(rows) >= long_rows


def test_work_list_counters(rng):
    counts, cp = _counts(rng, 3, [12, 3, 1], 5)
    wl = structure.WorkList.build(counts, cp, 4096)
    pieces, rows, ptr = structure.work_list(counts, cp, 4096)
    assert wl.num_pieces == len(pieces) and wl.split_rows == len(rows)
    assert wl.slots == int(ptr[-1]) and wl.budget == 4096
    assert wl.edges == int(counts.sum())
    per_row = [int(counts[cp[0]:cp[1], r].sum()) for r in rows]
    assert wl.split_edges == sum(per_row)
    assert 0 < wl.split_share < 1
    assert structure.WorkList.build(counts, cp, 10 ** 6) is None
    moved = wl.to("cpu")
    assert moved.num_pieces == wl.num_pieces and moved.slots == wl.slots


@pytest.mark.parametrize("edges,warps,want", [
    (76_534_337, 2640, 7248),    # the Reddit stand-in's block (PERF.md)
    (11_000, 2640, hub.DENSE_CT),  # a cora-size block: the floor
    (10 ** 9, 1, 250_000_000),
])
def test_split_budget(edges, warps, want):
    assert structure.split_budget(edges, warps) == want


@pytest.mark.parametrize("name,block", [("cora", "auto"),
                                        ("citeseer", "auto"),
                                        ("pubmed", (4096, 8192))])
def test_citation_blocks_yield_no_cut(name, block):
    """Cora's and citeseer's planned blocks and a forced pubmed block hold
    no row over the floor: a piece a row, no list, whatever the card."""
    d = synthetic.synthetic_citation(name)
    g = build_graph(d.src, d.dst, d.num_nodes, dense=block)
    for adj in (g.fwd, g.bwd):
        db = adj.dense
        counts = tile_row_edges(db).numpy()
        cp = db.chunk_ptr.numpy()
        for warps in (1, 2640, 10 ** 6):
            budget = structure.split_budget(int(counts.sum()), warps)
            pieces, rows, _ = structure.work_list(counts, cp, budget)
            assert len(rows) == 0 and len(pieces) == db.row_ids.shape[0]
            assert structure.WorkList.build(counts, cp, budget) is None


@pytest.mark.parametrize("way", ["fwd", "bwd"])
def test_tile_row_edges_counts_each_tile_rows_columns(rng, way):
    """The native library's count of each tile row's set bits, which the
    work list reads, against the unpacked mask."""
    if not native.available():
        pytest.skip("no g++: the native library cannot be built")
    db = getattr(hub_graph(rng), way).dense
    before = native.CALLS["tile_row_edges"]
    got = native.tile_row_edges(db.mask.numpy())
    assert native.CALLS["tile_row_edges"] == before + 1
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, tile_row_edges(db).numpy())


def test_held_work_lists_live_with_their_block(rng):
    """gmm_work gives a held list without reading the block, and the entry
    goes with the block."""
    db = hub_graph(rng).fwd.dense
    counts = tile_row_edges(db).numpy()
    wl = structure.WorkList.build(counts, db.chunk_ptr.numpy(), 2048)
    twin = dataclasses.replace(db)
    assert dense.hold_work(db, wl) is wl and dense.hold_work(twin, None) is None
    assert dense.gmm_work(db) is wl and dense.gmm_work(twin) is None
    key = id(twin)
    del twin
    gc.collect()
    assert key not in dense._WORK and dense.gmm_work(db) is wl


# ---------------------------------------------------------------------------
# (f): the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dense_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("h,f", [(4, 64), (1, 7), (3, 5), (8, 16)])
def test_cuda_kernels_match_plain(rng, cuda_device, dense_dtype, p, h, f):
    _, _, g = _multi_graph(rng)
    g = g.to(cuda_device)
    tb = {k: v.to(cuda_device) for k, v in
          _tables(rng, MULTI["n"], h, f).items()}
    tb["g"] = tb["g"] / 16  # see chip_smoke.py G_SCALE
    for with_pos in (True, False):
        args = (g.fwd.dense, tb["ar"], tb["ac"], tb["feat"])
        kw = dict(slope=SLOPE, with_pos=with_pos, p=p, seed=SEED,
                  dense_dtype=dense_dtype)
        before = dense.LAUNCHES["dense_gat_fwd"]
        got = dense.dense_gat_fwd(*args, **kw)
        assert dense.LAUNCHES["dense_gat_fwd"] == before + 1
        want = dense.dense_gat_fwd_plain(*args, **kw)
        torch.cuda.synchronize()
        for x, w in zip(got, want):
            if w is None:
                assert x is None
            else:
                torch.testing.assert_close(x, w, **BLOCK_TOL)
    args = (g.bwd.dense, *(tb[k] for k in ("g", "ar", "M", "Linv", "ws",
                                           "ac", "feat")))
    kw = dict(slope=SLOPE, p=p, seed=SEED, dense_dtype=dense_dtype)
    before = dense.LAUNCHES["dense_gat_bwd"]
    got = dense.dense_gat_bwd(*args, **kw)
    assert dense.LAUNCHES["dense_gat_bwd"] == before + 1
    want = dense.dense_gat_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, **BLOCK_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dense_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("h,f", [(4, 64), (1, 7), (3, 5), (8, 16)])
def test_cuda_fwd_matches_plain_on_hub_rows(rng, cuda_device, dense_dtype, p,
                                            h, f):
    """Rows over 32 edges (many batches of a row list), chunks of two column
    tiles and an empty real row: the forward kernel against its plain
    version, both heads-held instances, with and without the sign-split
    partials."""
    db = hub_block(hub_graph(rng).fwd.dense).to(cuda_device)
    tb = {k: v.to(cuda_device) for k, v in
          _tables(rng, HUB["n"], h, f).items()}
    tol = hub_tol(db.to("cpu"), BLOCK_TOL)
    for with_pos in (True, False):
        args = (db, tb["ar"], tb["ac"], tb["feat"])
        kw = dict(slope=SLOPE, with_pos=with_pos, p=p, seed=SEED,
                  dense_dtype=dense_dtype)
        before = dense.LAUNCHES["dense_gat_fwd"]
        got = dense.dense_gat_fwd(*args, **kw)
        assert dense.LAUNCHES["dense_gat_fwd"] == before + 1
        want = dense.dense_gat_fwd_plain(*args, **kw)
        torch.cuda.synchronize()
        for name, x, w in zip(("m", "l", "lpos", "acc", "accpos"), got,
                              want):
            if w is None:
                assert x is None
            else:
                _assert_close(x.cpu(), w.cpu(), dense_dtype, tol, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dense_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("h,f", [(4, 64), (1, 7), (3, 5), (8, 16)])
def test_cuda_bwd_matches_plain_on_hub_rows(rng, cuda_device, dense_dtype, p,
                                            h, f):
    """Rows over 32 edges (many batches of a row list), chunks of two column
    tiles and an empty real row: the backward kernel against its plain
    version, both heads-held instances."""
    db = hub_block(hub_graph(rng).bwd.dense).to(cuda_device)
    tb = {k: v.to(cuda_device) for k, v in
          _tables(rng, HUB["n"], h, f).items()}
    tb["g"] = tb["g"] / 16  # see chip_smoke.py G_SCALE
    tol = hub_tol(db.to("cpu"), BLOCK_TOL)
    args = (db, *(tb[k] for k in ("g", "ar", "M", "Linv", "ws", "ac",
                                  "feat")))
    kw = dict(slope=SLOPE, p=p, seed=SEED, dense_dtype=dense_dtype)
    before = dense.LAUNCHES["dense_gat_bwd"]
    got = dense.dense_gat_bwd(*args, **kw)
    assert dense.LAUNCHES["dense_gat_bwd"] == before + 1
    want = dense.dense_gat_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, x, w in zip(("dx", "dac"), got, want):
        _assert_close(x.cpu(), w.cpu(), dense_dtype, tol, name)
        assert not x[EMPTIED_ROW].any(), name


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(rng, cuda_device):
    _, _, g = _multi_graph(rng)
    g = g.to(cuda_device)
    tb = {k: v.to(cuda_device) for k, v in
          _tables(rng, MULTI["n"], 2, 4).items()}
    with pytest.raises(TypeError, match="float32"):
        dense.dense_gat_fwd(g.fwd.dense, tb["ar"],
                            tb["ac"].to(torch.bfloat16), tb["feat"],
                            slope=SLOPE, with_pos=True)
    wide = torch.zeros((MULTI["n"], 2, 600), device=cuda_device)
    with pytest.raises(ValueError, match="feature columns"):
        dense.dense_gat_fwd(g.fwd.dense, tb["ar"], tb["ac"], wide,
                            slope=SLOPE, with_pos=True)


# The MoNet kernels on a block whose rows are cut into pieces: a star of
# STAR["fan"] edges into node 0 and one out of node 1, over sparse random
# edges, every column in the block.
STAR = dict(n=48_000, fan=40_000, r=512)


def star_graph(rng):
    n, fan = STAR["n"], STAR["fan"]
    src, dst = _edges(rng, n, 2, power_law=False)
    into = rng.choice(np.arange(2, n), fan, replace=False)
    out_of = rng.choice(np.arange(2, n), fan * 3 // 4, replace=False)
    src = np.concatenate([src, into, np.full(len(out_of), 1)])
    dst = np.concatenate([dst, np.zeros(fan, np.int64), out_of])
    uniq = np.unique(np.stack([src, dst], 1), axis=0)
    return build_graph(uniq[:, 0], uniq[:, 1], n, dense=(STAR["r"], n))


@pytest.mark.cuda
@pytest.mark.parametrize("dense_dtype", ["float32", "bfloat16"])
def test_cuda_gmm_kernels_on_cut_rows_match_plain(rng, cuda_device,
                                                  dense_dtype):
    """A block with rows far over the work list's budget: K7 and K8 walk
    their pieces and merge them, match their plain versions, and give the
    same bytes on a second launch."""
    g = star_graph(rng)
    n, k, f, d, dd = STAR["n"], 2, 64, 2, 2  # the models' instance, 8 a lane

    def a(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(cuda_device)

    t = dict(feat=a(n, k, f), g=a(n, k, f) / 16, alpha=a(n, d),
             beta=a(n, d), dfeat=a(n, dd), mu=a(k, d),
             isig=torch.rand(k, d, device=cuda_device) + 0.5)
    fwd_args = ("beta", "alpha", "feat", "mu", "isig")
    bwd_args = ("g", "beta", "dfeat", "alpha", "feat", "mu", "isig")
    kw = dict(use_tanh=True, dense_dtype=dense_dtype)
    for way, fn, plain, keys in (
            ("fwd", dense.dense_gmm_fwd, dense.dense_gmm_fwd_plain,
             fwd_args),
            ("bwd", dense.dense_gmm_bwd, dense.dense_gmm_bwd_plain,
             bwd_args)):
        host = getattr(g, way).dense
        # hub_tol's rule, atol grown in units of 128 terms, taken to the
        # widest row: its terms span many tiles here (as the widest row
        # sets the tolerance of test_torch_gmm.py's CUDA block tests)
        per, cp = tile_row_edges(host), host.chunk_ptr.tolist()
        widest = max(int(per[a:b].sum(dim=0).max())
                     for a, b in zip(cp[:-1], cp[1:]))
        tol = dict(BLOCK_TOL, atol=BLOCK_TOL["atol"] * widest / 128)
        db = host.to(cuda_device)
        wl = dense.gmm_work(db)
        assert wl is not None and wl.split_rows >= 1, way
        assert wl.budget == structure.ROW_FLOOR and wl.split_share > 0.3
        assert dense.gmm_work(db) is wl
        before = dict(dense.LAUNCHES)
        args = (db, *(t[key] for key in keys))
        got = fn(*args, **kw)
        again = fn(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        name = "dense_gmm_" + way
        assert dense.LAUNCHES[name] == before[name] + 2
        assert dense.LAUNCHES["dense_gmm_merge"] == (
            before["dense_gmm_merge"] + 2)
        for x, y, z in zip(*(v if isinstance(v, tuple) else (v,)
                             for v in (got, again, want))):
            assert torch.equal(x, y), way
            _assert_close(x.cpu(), z.cpu(), dense_dtype, tol, way)
