"""Per-bin GAT passes: the port's plain versions against the JAX package's
Pallas kernels (run in interpret mode off-TPU) on the same gathered data,
and, on a CUDA device, the port's kernels against their plain versions.

JAX is imported inside the JAX tests only, so that the CUDA test runs on a
machine without JAX:  python -m pytest --noconftest -m cuda
tests/test_torch_bins.py
"""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import numpy as np
import pytest
import torch

from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.ops import bins

SLOPE = 0.2
SEED = 2 ** 31 + 12345  # a uint32 seed above the int32 range
TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)  # summation order differs


def _sum_tol(segs, tol=None):
    """Kernel against plain over bins up to W slots: sums of W terms in
    another order, rtol 1e-5 and atol 8 W 2^-23; with ``tol``, its rtol and
    the larger of its atol and 8 W 2^-23."""
    atol = 8 * max(nbr.shape[1] for nbr, _, _ in segs) * 2.0 ** -23
    if tol is None:
        return dict(rtol=1e-5, atol=atol)
    return dict(tol, atol=max(tol["atol"], atol))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _bin(rng, n=120, s=16, w=8, h=2, f=5):
    """One bin's tables with partial, full and empty segments."""
    count = rng.integers(1, w + 1, s).astype(np.int32)
    count[[0, 5]] = 0        # empty segments
    count[1] = w             # a full one
    nbr = rng.integers(0, n, (s, w)).astype(np.int32)
    nbr[np.arange(w)[None, :] >= count[:, None]] = 0  # padded slots
    row = rng.integers(0, n, s).astype(np.int32)
    t = dict(
        nbr=nbr, row=row, count=count,
        feat=rng.normal(size=(n, h, f)).astype(np.float32),
        ac=rng.normal(size=(n, h)).astype(np.float32),
        ar=rng.normal(size=(n, h)).astype(np.float32),
        g=rng.normal(size=(n, h, f)).astype(np.float32),
        M=(rng.normal(size=(n, h)) + 2.0).astype(np.float32),
        Linv=rng.uniform(0.1, 1.0, (n, h)).astype(np.float32),
        ws=rng.normal(size=(n, h)).astype(np.float32),
    )
    return t


def _torch(t, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in t.items()}


def _fwd_args(t):
    return (t["feat"], t["ac"], t["ar"], t["nbr"], t["row"], t["count"])


def _bwd_args(t):
    return (t["g"], t["ar"], t["M"], t["Linv"], t["ws"], t["ac"], t["feat"],
            t["nbr"], t["row"], t["count"])


@pytest.mark.parametrize("with_pos", [True, False])
@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("h,f", [(2, 5), (1, 3)])
def test_fwd_plain_matches_jax_kernel(rng, with_pos, p, h, f):
    import jax.numpy as jnp

    from dgnn_tpu.ops.pallas_bins import bin_gat_fwd as jax_fwd

    t = _bin(rng, h=h, f=f)
    n = t["feat"].shape[0]
    xcat = np.concatenate([t["feat"].reshape(n, -1), t["ac"]], axis=1)
    drop = None
    if p > 0:
        drop = (p, jnp.uint32(SEED), jnp.asarray(t["row"]),
                jnp.asarray(t["nbr"].T))
    want = jax_fwd(jnp.asarray(xcat[t["nbr"].T]),
                   jnp.asarray(t["ar"][t["row"]]), jnp.asarray(t["count"]),
                   H=h, F=f, slope=SLOPE, with_pos=with_pos, drop=drop,
                   interpret=True)
    got = bins.bin_gat_fwd_plain(*_fwd_args(_torch(t)), slope=SLOPE,
                                 with_pos=with_pos, p=p, seed=SEED)
    # the wrapper takes the plain version for CPU tensors
    via_wrapper = bins.bin_gat_fwd(*_fwd_args(_torch(t)), slope=SLOPE,
                                   with_pos=with_pos, p=p, seed=SEED)
    names = ("m", "l", "lpos", "acc", "accpos")
    for name, w, g, v in zip(names, want, got, via_wrapper):
        if not with_pos and name in ("lpos", "accpos"):
            assert w is None and g is None and v is None
            continue
        g = g.reshape(g.shape[0], -1).numpy()
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **TOL)
        np.testing.assert_array_equal(v.reshape(v.shape[0], -1).numpy(), g)
    # empty segments: the kernels' finite sentinel and zero partials
    assert np.all(got[0][[0, 5]].numpy() == np.float32(-1e30))
    assert np.all(got[3][[0, 5]].numpy() == 0)


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("h,f", [(2, 5), (1, 3)])
def test_bwd_plain_matches_jax_kernel(rng, p, h, f):
    import jax.numpy as jnp

    from dgnn_tpu.ops.pallas_bins import bin_gat_bwd as jax_bwd

    t = _bin(rng, h=h, f=f)
    n = t["feat"].shape[0]
    zcat = np.concatenate([t["g"].reshape(n, -1), t["ar"], t["M"],
                           t["Linv"], t["ws"]], axis=1)
    drop = None
    if p > 0:
        drop = (p, jnp.uint32(SEED), jnp.asarray(t["row"]),
                jnp.asarray(t["nbr"].T))
    want_dx, want_dac = jax_bwd(
        jnp.asarray(zcat[t["nbr"].T]), jnp.asarray(t["ac"][t["row"]]),
        jnp.asarray(t["feat"].reshape(n, -1)[t["row"]]),
        jnp.asarray(t["count"]), H=h, slope=SLOPE, drop=drop, interpret=True)
    dx, dac = bins.bin_gat_bwd_plain(*_bwd_args(_torch(t)), slope=SLOPE, p=p,
                                     seed=SEED)
    np.testing.assert_allclose(dx.reshape(dx.shape[0], -1).numpy(),
                               np.asarray(want_dx), **BWD_TOL)
    np.testing.assert_allclose(dac.numpy(), np.asarray(want_dac), **BWD_TOL)
    assert np.all(dx[[0, 5]].numpy() == 0) and np.all(dac[[0, 5]].numpy() == 0)


def _graph_bins(rng, kind, widths=None):
    """The CSR and CSC bins of a small graph as lists of (nbr, row, count)
    int32 tensors, with the widest bin's first segment emptied in each.
    "pubmed_like": uniform degrees, bins (4, 8, 12) as synthetic pubmed's;
    "power_law": Zipf in-degrees, bins (8, 128), hub rows split into
    several 128-slot segments."""
    if kind == "pubmed_like":
        n, w = 300, (4, 8, 12)
        src, dst = rng.integers(0, n, 1500), rng.integers(0, n, 1500)
    else:
        n, w = 400, (8, 128)
        src = rng.integers(0, n, 6 * n)
        dst = np.minimum(rng.zipf(1.6, 6 * n) - 1, n - 1)
    uniq = np.unique(np.stack([src, dst], 1), axis=0)
    g = build_graph(uniq[:, 0], uniq[:, 1], n, widths=widths or w,
                    edge_tables=False)
    fwd = [(nbr, row, count.clone()) for _w, nbr, _e, row, count
           in g.fwd.bins()]
    fwd[-1][2][0] = 0  # an empty segment in the widest bin
    bwd = [(nbr, row, count.clone()) for _w, nbr, _e, row, count
           in g.bwd.bins()]
    bwd[-1][2][0] = 0
    return n, fwd, bwd


def _node_tables(rng, n, h, f):
    a = {k: rng.normal(size=s).astype(np.float32)
         for k, s in (("feat", (n, h, f)), ("ac", (n, h)), ("ar", (n, h)))}
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _bwd_tables(rng, n, h, f):
    """The node tables and the backward's destination tables: g at 1/16
    scale (chip_smoke.py's G_SCALE: d ac is a difference of sums whose
    float32 rounding floor grows with |g|), M = N(3, 1) and 1 / L in
    [0.1, 1], so that most attention weights lie in [0, 1] as on the main
    path."""
    t = _node_tables(rng, n, h, f)
    a = dict(g=rng.normal(size=(n, h, f)) / 16, M=rng.normal(size=(n, h)) + 3,
             Linv=rng.uniform(0.1, 1.0, (n, h)), ws=rng.normal(size=(n, h)))
    t.update({k: torch.from_numpy(v.astype(np.float32)) for k, v in a.items()})
    return t


def _list_bwd_args(t):
    return tuple(t[k] for k in ("g", "ar", "M", "Linv", "ws", "ac", "feat"))


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("kind", ["pubmed_like", "power_law"])
def test_fwd_list_plain_is_per_bin_then_cat_and_matches_jax(rng, kind, p):
    """The list wrapper's plain path: the per-bin plain versions followed by
    torch.cat, and the JAX per-bin kernels (interpret mode) concatenated."""
    import jax.numpy as jnp

    from dgnn_tpu.ops.pallas_bins import bin_gat_fwd as jax_fwd

    h, f = 2, 5
    n, segs, _ = _graph_bins(rng, kind)
    t = _node_tables(rng, n, h, f)
    kw = dict(slope=SLOPE, with_pos=True, p=p, seed=SEED)
    got = bins.bin_gat_fwd_list(t["feat"], t["ac"], t["ar"], segs, **kw)
    per_bin = [bins.bin_gat_fwd(t["feat"], t["ac"], t["ar"], *seg, **kw)
               for seg in segs]
    xcat = np.concatenate([t["feat"].numpy().reshape(n, -1),
                           t["ac"].numpy()], axis=1)
    want = []
    for nbr, row, count in segs:
        nb, rw = nbr.numpy(), row.numpy()
        drop = (p, jnp.uint32(SEED), jnp.asarray(rw),
                jnp.asarray(nb.T)) if p > 0 else None
        want.append(jax_fwd(jnp.asarray(xcat[nb.T]),
                            jnp.asarray(t["ar"].numpy()[rw]),
                            jnp.asarray(count.numpy()), H=h, F=f,
                            slope=SLOPE, with_pos=True, drop=drop,
                            interpret=True))
    names = ("m", "l", "lpos", "acc", "accpos")
    for i, name in enumerate(names):
        torch.testing.assert_close(
            got[i], torch.cat([pb[i] for pb in per_bin]), rtol=0, atol=0)
        w = np.concatenate([np.asarray(wb[i]) for wb in want])
        np.testing.assert_allclose(
            got[i].reshape(got[i].shape[0], -1).numpy(), w, err_msg=name,
            **TOL)
    # the empty segment: the first of the widest bin
    first = sum(nbr.shape[0] for nbr, _, _ in segs[:-1])
    assert np.all(got[0][first].numpy() == np.float32(-1e30))
    assert np.all(got[3][first].numpy() == 0)


@pytest.mark.parametrize("with_pos", [True, False])
def test_fwd_list_appends_the_tail(rng, with_pos):
    """A tail (the hub block's partials) follows the bins' rows; without
    sign-split partials lpos / accpos stay None; no bins at all leave the
    tail alone."""
    n, segs, _ = _graph_bins(rng, "pubmed_like")
    t = _node_tables(rng, n, 2, 3)
    kw = dict(slope=SLOPE, with_pos=with_pos)
    tail = tuple(None if not with_pos and i in (2, 4) else
                 torch.randn((7, 2) if i < 3 else (7, 2, 3))
                 for i in range(5))
    got = bins.bin_gat_fwd_list(t["feat"], t["ac"], t["ar"], segs,
                                tail=tail, **kw)
    bare = bins.bin_gat_fwd_list(t["feat"], t["ac"], t["ar"], segs, **kw)
    only = bins.bin_gat_fwd_list(t["feat"], t["ac"], t["ar"], [], tail=tail,
                                 **kw)
    none = bins.bin_gat_fwd_list(t["feat"], t["ac"], t["ar"], [], **kw)
    for i in range(5):
        if tail[i] is None:
            assert got[i] is None and only[i] is None and none[i] is None
            continue
        assert torch.equal(got[i], torch.cat([bare[i], tail[i]]))
        assert torch.equal(only[i], tail[i])
        assert none[i].shape[0] == 0


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("kind", ["pubmed_like", "power_law"])
def test_bwd_list_plain_is_per_bin_then_cat_and_matches_jax(rng, kind, p):
    """The backward list wrapper's plain path: the per-bin plain versions
    followed by torch.cat, and the JAX per-bin kernels (interpret mode)
    concatenated, to rtol 1e-4 and atol the larger of 1e-5 and 8 W 2^-23
    (sums of up to W signed terms in another order)."""
    import jax.numpy as jnp

    from dgnn_tpu.ops.pallas_bins import bin_gat_bwd as jax_bwd

    h, f = 2, 5
    n, _, segs = _graph_bins(rng, kind)
    t = _bwd_tables(rng, n, h, f)
    kw = dict(slope=SLOPE, p=p, seed=SEED)
    got = bins.bin_gat_bwd_list(*_list_bwd_args(t), segs, **kw)
    per_bin = [bins.bin_gat_bwd(*_list_bwd_args(t), *seg, **kw)
               for seg in segs]
    a = {k: v.numpy() for k, v in t.items()}
    zcat = np.concatenate([a["g"].reshape(n, -1), a["ar"], a["M"], a["Linv"],
                           a["ws"]], axis=1)
    want = []
    for nbr, row, count in segs:
        nb, rw = nbr.numpy(), row.numpy()
        drop = (p, jnp.uint32(SEED), jnp.asarray(rw),
                jnp.asarray(nb.T)) if p > 0 else None
        want.append(jax_bwd(jnp.asarray(zcat[nb.T]), jnp.asarray(a["ac"][rw]),
                            jnp.asarray(a["feat"].reshape(n, -1)[rw]),
                            jnp.asarray(count.numpy()), H=h, slope=SLOPE,
                            drop=drop, interpret=True))
    for i, name in enumerate(("dx", "dac")):
        torch.testing.assert_close(
            got[i], torch.cat([pb[i] for pb in per_bin]), rtol=0, atol=0)
        w = np.concatenate([np.asarray(wb[i]) for wb in want])
        np.testing.assert_allclose(
            got[i].reshape(got[i].shape[0], -1).numpy(), w, err_msg=name,
            **_sum_tol(segs, BWD_TOL))
    # the empty segment: the first of the widest bin
    first = sum(nbr.shape[0] for nbr, _, _ in segs[:-1])
    assert np.all(got[0][first].numpy() == 0)
    assert np.all(got[1][first].numpy() == 0)


def test_bwd_list_appends_the_tail(rng):
    """A tail (the hub block's dx, dac rows) follows the bins' rows; no
    bins at all leave the tail alone."""
    n, _, segs = _graph_bins(rng, "pubmed_like")
    args = _list_bwd_args(_bwd_tables(rng, n, 2, 3))
    tail = (torch.randn((7, 2, 3)), torch.randn((7, 2)))
    got = bins.bin_gat_bwd_list(*args, segs, slope=SLOPE, tail=tail)
    bare = bins.bin_gat_bwd_list(*args, segs, slope=SLOPE)
    only = bins.bin_gat_bwd_list(*args, [], slope=SLOPE, tail=tail)
    none = bins.bin_gat_bwd_list(*args, [], slope=SLOPE)
    for i in range(2):
        assert torch.equal(got[i], torch.cat([bare[i], tail[i]]))
        assert torch.equal(only[i], tail[i])
        assert none[i].shape == (0, *tail[i].shape[1:])


def test_wrappers_refuse_mixed_devices(rng):
    t = _torch(_bin(rng))
    bad = dict(t, ar=t["ar"].to("meta"))
    with pytest.raises(ValueError, match="devices"):
        bins.bin_gat_fwd(*_fwd_args(bad), slope=SLOPE, with_pos=True)
    with pytest.raises(ValueError, match="shapes"):
        bins.bin_gat_bwd(*_bwd_args(dict(t, row=t["row"][:3])), slope=SLOPE)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("w,h,f", [(4, 4, 64), (12, 1, 3), (96, 2, 5),
                                   (8, 4, 300)])
def test_cuda_kernels_match_plain(rng, cuda_device, p, w, h, f):
    t = _torch(_bin(rng, n=500, s=40, w=w, h=h, f=f), cuda_device)
    for with_pos in (True, False):
        before = bins.LAUNCHES["bin_gat_fwd"]
        got = bins.bin_gat_fwd(*_fwd_args(t), slope=SLOPE, with_pos=with_pos,
                               p=p, seed=SEED)
        assert bins.LAUNCHES["bin_gat_fwd"] == before + 1
        want = bins.bin_gat_fwd_plain(*_fwd_args(t), slope=SLOPE,
                                      with_pos=with_pos, p=p, seed=SEED)
        torch.cuda.synchronize()
        for g, wv in zip(got, want):
            if wv is None:
                assert g is None
            else:
                torch.testing.assert_close(g, wv, **TOL)
    before = bins.LAUNCHES["bin_gat_bwd"]
    got = bins.bin_gat_bwd(*_bwd_args(t), slope=SLOPE, p=p, seed=SEED)
    assert bins.LAUNCHES["bin_gat_bwd"] == before + 1
    want = bins.bin_gat_bwd_plain(*_bwd_args(t), slope=SLOPE, p=p, seed=SEED)
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        torch.testing.assert_close(g, wv, **BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("h,f", [(4, 64), (1, 3), (2, 5), (3, 12)])
@pytest.mark.parametrize("kind", ["pubmed_like", "power_law"])
def test_cuda_fwd_list_matches_plain(rng, cuda_device, kind, h, f, p):
    """Every bin in one launch against the plain version, W up to 128 with
    an empty segment, and against the per-bin launches bit for bit (the
    same kernel); a hub-block tail is copied in after the bins."""
    n, segs, _ = _graph_bins(rng, kind)
    segs = [tuple(x.to(cuda_device) for x in seg) for seg in segs]
    t = {k: v.to(cuda_device) for k, v in _node_tables(rng, n, h, f).items()}
    args = (t["feat"], t["ac"], t["ar"])
    for with_pos in (True, False):
        kw = dict(slope=SLOPE, with_pos=with_pos, p=p, seed=SEED)
        tail = bins.bin_gat_fwd_plain(*args, *segs[0], **kw)
        before = bins.LAUNCHES["bin_gat_fwd"]
        got = bins.bin_gat_fwd_list(*args, segs, tail=tail, **kw)
        assert bins.LAUNCHES["bin_gat_fwd"] == before + 1
        want = bins.bin_gat_fwd_list_plain(*args, segs, tail=tail, **kw)
        per_bin = [bins.bin_gat_fwd(*args, *seg, **kw) for seg in segs]
        torch.cuda.synchronize()
        for i, (g, wv) in enumerate(zip(got, want)):
            if wv is None:
                assert g is None
                continue
            torch.testing.assert_close(g, wv, **_sum_tol(segs))
            assert torch.equal(g, torch.cat([pb[i] for pb in per_bin]
                                            + [tail[i]]))


@pytest.mark.cuda
def test_cuda_fwd_list_takes_more_bins_than_a_launch(rng, cuda_device):
    """Nine bins: two launches, the second's rows after the first's."""
    n, segs, _ = _graph_bins(rng, "pubmed_like",
                             widths=(1, 2, 3, 4, 5, 6, 7, 8, 16))
    assert len(segs) > bins.MAX_BINS_PER_LAUNCH
    segs = [tuple(x.to(cuda_device) for x in seg) for seg in segs]
    t = {k: v.to(cuda_device) for k, v in _node_tables(rng, n, 4, 8).items()}
    args = (t["feat"], t["ac"], t["ar"])
    kw = dict(slope=SLOPE, with_pos=True, p=0.3, seed=SEED)
    before = bins.LAUNCHES["bin_gat_fwd"]
    got = bins.bin_gat_fwd_list(*args, segs, **kw)
    assert bins.LAUNCHES["bin_gat_fwd"] == before + 2
    want = bins.bin_gat_fwd_list_plain(*args, segs, **kw)
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        torch.testing.assert_close(g, wv, **_sum_tol(segs))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("h,f", [(4, 64), (1, 3), (2, 5), (3, 12)])
@pytest.mark.parametrize("kind", ["pubmed_like", "power_law"])
def test_cuda_bwd_list_matches_plain(rng, cuda_device, kind, h, f, p):
    """The backward's every bin in one launch against the plain version, W
    up to 128 with an empty segment, F % 4 != 0, and against the per-bin
    launches bit for bit (the same kernel); a hub-block tail is copied in
    after the bins."""
    n, _, segs = _graph_bins(rng, kind)
    segs = [tuple(x.to(cuda_device) for x in seg) for seg in segs]
    args = tuple(x.to(cuda_device)
                 for x in _list_bwd_args(_bwd_tables(rng, n, h, f)))
    kw = dict(slope=SLOPE, p=p, seed=SEED)
    tail = bins.bin_gat_bwd_plain(*args, *segs[0], **kw)
    before = bins.LAUNCHES["bin_gat_bwd"]
    got = bins.bin_gat_bwd_list(*args, segs, tail=tail, **kw)
    assert bins.LAUNCHES["bin_gat_bwd"] == before + 1
    want = bins.bin_gat_bwd_list_plain(*args, segs, tail=tail, **kw)
    per_bin = [bins.bin_gat_bwd(*args, *seg, **kw) for seg in segs]
    torch.cuda.synchronize()
    for i in range(2):
        torch.testing.assert_close(got[i], want[i], **_sum_tol(segs, BWD_TOL))
        assert torch.equal(got[i], torch.cat([pb[i] for pb in per_bin]
                                             + [tail[i]]))


@pytest.mark.cuda
def test_cuda_bwd_list_takes_more_bins_than_a_launch(rng, cuda_device):
    """Nine backward bins: two launches, the second's rows after the
    first's."""
    n, _, segs = _graph_bins(rng, "pubmed_like",
                             widths=(1, 2, 3, 4, 5, 6, 7, 8, 16))
    assert len(segs) > bins.MAX_BINS_PER_LAUNCH
    segs = [tuple(x.to(cuda_device) for x in seg) for seg in segs]
    args = tuple(x.to(cuda_device)
                 for x in _list_bwd_args(_bwd_tables(rng, n, 4, 8)))
    kw = dict(slope=SLOPE, p=0.3, seed=SEED)
    before = bins.LAUNCHES["bin_gat_bwd"]
    got = bins.bin_gat_bwd_list(*args, segs, **kw)
    assert bins.LAUNCHES["bin_gat_bwd"] == before + 2
    want = bins.bin_gat_bwd_list_plain(*args, segs, **kw)
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        torch.testing.assert_close(g, wv, **_sum_tol(segs, BWD_TOL))


@pytest.mark.cuda
def test_cuda_wrappers_take_bf16_rows_and_refuse_other_types(rng,
                                                            cuda_device):
    """bf16 feature rows launch the kernels' bf16 instances (equal to the
    plain versions on the same bf16 rows); float16, float64 and a mix of
    row types are refused."""
    t = _torch(_bin(rng, h=4, f=64), cuda_device)
    rows = dict(t, feat=t["feat"].to(torch.bfloat16),
                g=t["g"].to(torch.bfloat16))
    kw = dict(slope=SLOPE, with_pos=True, p=0.3, seed=SEED)
    got = bins.bin_gat_fwd(*_fwd_args(rows), **kw)
    want = bins.bin_gat_fwd_plain(*_fwd_args(rows), **kw)
    bkw = dict(slope=SLOPE, p=0.3, seed=SEED)
    got += bins.bin_gat_bwd(*_bwd_args(rows), **bkw)
    want += bins.bin_gat_bwd_plain(*_bwd_args(rows), **bkw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)
    for dtype in (torch.float16, torch.float64):
        bad = dict(t, feat=t["feat"].to(dtype))
        with pytest.raises(TypeError, match="float32"):
            bins.bin_gat_fwd(*_fwd_args(bad), slope=SLOPE, with_pos=True)
        bad = dict(t, g=t["g"].to(dtype), feat=t["feat"].to(dtype))
        with pytest.raises(TypeError, match="float32"):
            bins.bin_gat_bwd_list(*_bwd_args(bad)[:7], [_bwd_args(bad)[7:]],
                                  slope=SLOPE)
    mixed = dict(t, g=t["g"].to(torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        bins.bin_gat_bwd(*_bwd_args(mixed), slope=SLOPE)
