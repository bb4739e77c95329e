"""The port's native graph library (dgnn_tpu_torch/native) against the
port's numpy versions and against the JAX package's native library and
numpy graph functions: every array equal."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import pathlib

import numpy as np
import pytest
import torch

import dgnn_tpu.graph.binning as jbinning
import dgnn_tpu.graph.build as jbuild
import dgnn_tpu.graph.hub as jhub
from dgnn_tpu import native as jnative
from dgnn_tpu_torch import native
from dgnn_tpu_torch.data import synthetic
from dgnn_tpu_torch.graph import binning, build, hub, structure

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("no g++ on the PATH")
    native.load()
    return native


def _multigraph(rng, n, e, hot=0):
    """Edges with duplicates and nodes no edge touches (empty rows and
    columns): ids drawn from the lower 3/4 of [0, n), ``hot`` of them into
    node 0 (a wide row)."""
    src = rng.integers(0, 3 * n // 4, e)
    dst = rng.integers(0, 3 * n // 4, e)
    dst[:hot] = 0
    src = np.concatenate([src, src[:e // 5]])  # a fifth of them twice
    dst = np.concatenate([dst, dst[:e // 5]])
    return src, dst


def _jax_numpy(monkeypatch):
    """The JAX package's graph functions on their numpy branch."""
    for mod in (jbuild, jbinning):
        monkeypatch.setattr(mod, "_native", lambda: None)


@pytest.mark.parametrize("n,e,hot", [(1, 0, 0), (50, 300, 0),
                                     (400, 3000, 500)])
def test_csr_and_csc_equal_numpy_and_jax(rng, lib, monkeypatch, n, e, hot):
    src, dst = _multigraph(rng, n, e, hot)
    got = lib.coo_to_csr(src, dst, n)
    plain = build._coo_to_csr_numpy(src.astype(np.int64),
                                    dst.astype(np.int64), n)
    jnat = jnative.coo_to_csr(src, dst, n)
    _jax_numpy(monkeypatch)
    jplain = jbuild.coo_to_csr(src, dst, n)
    for want in (plain, jnat, jplain):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert (np.diff(got[0]) == 0).any() or n == 1  # empty rows
    csc = lib.csr_to_csc_permute(*got)
    for want in (build._csr_to_csc_permute_numpy(*got),
                 jnative.csr_to_csc_permute(*got),
                 jbuild.csr_to_csc_permute(*got)):
        for a, b in zip(csc, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("width", [1, 4, 16])
def test_bin_fill_equals_numpy_and_jax(rng, lib, monkeypatch, width):
    n, e = 300, 2000
    row_ptr, col_ind = lib.coo_to_csr(*_multigraph(rng, n, e, 100), n)
    deg = np.diff(row_ptr)
    rows = np.nonzero(deg)[0]
    starts = row_ptr[rows] + rng.integers(0, 2, rows.shape[0]) * (deg[rows]
                                                                 > width)
    counts = np.minimum(width, row_ptr[rows + 1] - starts)
    counts[::7] = 0  # empty segments
    edge_ids = rng.permutation(col_ind.shape[0]).astype(np.int64)
    got = lib.bin_fill(starts, counts, width, col_ind, edge_ids)
    want = binning._bin_fill_numpy(starts, counts, width, col_ind, edge_ids)
    args = (row_ptr, col_ind, edge_ids, rows, starts, counts, width)
    jnat = jbinning._build_bin(*args)
    _jax_numpy(monkeypatch)
    jplain = jbinning._build_bin(*args)
    for j in (jnat, jplain):  # padded to a multiple of 8 segments
        for a, b in zip(got, j[:2]):
            np.testing.assert_array_equal(a, b[:rows.shape[0]])
            assert not b[rows.shape[0]:].any()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    # the port's _build_bin pads to the JAX package's segment multiple
    port = binning._build_bin(col_ind, edge_ids, rows, starts, counts, width)
    for a, b in zip(port, jnat):
        np.testing.assert_array_equal(a, b)


def test_mask_fill_every_column_slot(rng, lib):
    """Every column slot of two tiles set once in some row, and a random
    pattern with repeats: the bit-plane layout of pack_mask_bits (port and
    JAX) for each."""
    ct, rpad = hub.DENSE_CT, 24
    cpad = 2 * ct
    cols = np.concatenate([np.arange(cpad), rng.integers(0, cpad, 3000)])
    rows = np.concatenate([np.arange(cpad) % rpad,
                           rng.integers(0, rpad, 3000)])
    got = lib.dense_mask_fill(rows, cols, rpad, cpad, ct)
    mask01 = np.zeros((rpad, cpad), bool)
    mask01[rows, cols] = True
    np.testing.assert_array_equal(got, hub.pack_mask_bits(mask01))
    np.testing.assert_array_equal(got, jhub.pack_mask_bits(mask01))
    np.testing.assert_array_equal(
        got, hub._mask_fill_numpy(rows, cols, rpad, cpad, ct))
    np.testing.assert_array_equal(
        got, jnative.dense_mask_fill(rows, cols, rpad, cpad, ct))


@pytest.mark.parametrize("forced", [None, (40, 100)])
def test_build_dense_equals_numpy_and_jax(rng, lib, monkeypatch, forced):
    """A hub block on a skewed multigraph: the planner's, or a forced one
    (every tile kept, padded rows and columns)."""
    n = 2500
    src, dst = _multigraph(rng, n, 20000, 3000)
    rp, ci = lib.coo_to_csr(src, dst, n)
    if forced is None:
        cp, _, _ = lib.csr_to_csc_permute(rp, ci)
        sel = hub.plan_dense(rp, ci, np.diff(cp))
        assert sel is not None
    else:
        sel = (np.argsort(np.diff(rp), kind="stable")[::-1][:forced[0]],
               rng.permutation(n)[:forced[1]], None)
    got = hub.build_dense_numpy(rp, ci, *sel)
    want = jhub.build_dense_numpy(rp, ci, *sel)
    monkeypatch.setenv("DGNN_TPU_NATIVE", "0")
    plain = hub.build_dense_numpy(rp, ci, *sel)
    for other in (want, plain):
        for key in ("row_ids", "col_ids", "mask", "rc", "ct", "first"):
            np.testing.assert_array_equal(getattr(got[0], key),
                                          getattr(other[0], key),
                                          err_msg=key)
        for a, b in zip(got[1:], other[1:]):
            np.testing.assert_array_equal(a, b)
    assert got[0].mask.any()


def _graph_arrays(g):
    out = {k: getattr(g, k) for k in ("row_ptr", "col_ind", "col_ptr",
                                      "row_ind", "permute")}
    for name in ("fwd", "bwd"):
        a = getattr(g, name)
        for key in ("nbr", "edge", "row", "count"):
            for i, t in enumerate(getattr(a, key)):
                out[f"{name}.{key}{i}"] = t
        for key in ("main", "ov_rows", "ov"):
            out[f"{name}.cmb.{key}"] = getattr(a.cmb, key)
        out[f"{name}.epos"] = a.epos
        if a.dense is not None:
            for key in ("row_ids", "col_ids", "mask", "rc", "ct", "first",
                        "chunk_ptr"):
                out[f"{name}.dense.{key}"] = getattr(a.dense, key)
    return out


@pytest.mark.parametrize("name,dense", [("cora", "auto"), ("cora", None),
                                        ("citeseer", (300, 2500))])
def test_graph_without_the_library_equals_graph_with_it(lib, monkeypatch,
                                                        name, dense):
    d = synthetic.synthetic_citation(name)
    native.reset_calls()
    got = structure.build_graph(d.src, d.dst, d.num_nodes, dense=dense)
    calls = dict(native.CALLS)
    assert calls["coo_to_csr"] == calls["csr_to_csc_permute"] == 1
    assert calls["bin_fill"] >= 2
    assert calls["dense_mask_fill"] == (0 if dense is None else 2)
    monkeypatch.setenv("DGNN_TPU_NATIVE", "0")
    assert not native.available()
    want = structure.build_graph(d.src, d.dst, d.num_nodes, dense=dense)
    assert native.CALLS == calls  # the numpy versions only
    a, b = _graph_arrays(got), _graph_arrays(want)
    assert a.keys() == b.keys()
    for key in a:
        if b[key] is None:
            assert a[key] is None, key
            continue
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key


def test_available_only_with_gpp_and_not_switched_off(monkeypatch):
    monkeypatch.delenv("DGNN_TPU_NATIVE", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    monkeypatch.undo()
    monkeypatch.setenv("DGNN_TPU_NATIVE", "0")
    assert not native.available()


def test_library_builds_under_build_never_beside_the_source(lib):
    path = native.library_path()
    assert path.exists()
    assert path.is_relative_to(ROOT / "build" / "dgnn_tpu_torch" / "native")
    here = pathlib.Path(native.__file__).parent
    assert sorted(p.name for p in here.iterdir()
                  if p.suffix in (".so", ".tmp")) == []


def test_failed_build_raises(lib, tmp_path, monkeypatch):
    bad = tmp_path / "graph_prep.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not native.library_path().exists()


def test_bindings_refuse_bad_arguments(lib):
    with pytest.raises(ValueError, match="outside"):
        lib.coo_to_csr(np.array([0, 5]), np.array([1, 1]), 5)
    with pytest.raises(ValueError, match="outside"):
        lib.coo_to_csr(np.array([0, -1]), np.array([1, 1]), 5)
    with pytest.raises(ValueError, match="row pointer"):
        lib.csr_to_csc_permute(np.array([0, 3]), np.array([0, 0], np.int32))
    with pytest.raises(ValueError, match="wider"):
        lib.bin_fill(np.array([0]), np.array([3]), 2,
                     np.zeros(4, np.int32), np.arange(4))
    with pytest.raises(ValueError, match="outside"):
        lib.bin_fill(np.array([2]), np.array([3]), 4,
                     np.zeros(4, np.int32), np.arange(4))
    with pytest.raises(ValueError, match="outside"):
        lib.dense_mask_fill(np.array([4]), np.array([0]), 4, 2048, 2048)
    with pytest.raises(ValueError, match="multiple of 8"):
        lib.dense_mask_fill(np.array([0]), np.array([0]), 4, 2048, 1000)


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's native library (built beside its source at first
    use), for the R-MAT generator's bit-for-bit comparison."""
    if not jnative.available():
        pytest.skip("the JAX package's native library does not load "
                    "(no g++?)")
    return jnative


@pytest.mark.parametrize("n,e,seed,abc", [
    (1000, 5000, 42, ()),
    (1000, 5001, 42, ()),                # odd: the mirrored half is cut
    (3000, 20000, 7, ()),                # n not a power of two
    (3000, 9999, 5, (0.45, 0.15, 0.25)),
    (1, 3, 0, ()),
    (17, 0, 3, ()),
])
def test_rmat_edges_equal_jax_bit_for_bit(lib, jax_lib, n, e, seed, abc):
    native.reset_calls()
    got = lib.rmat_edges(n, e, seed, *abc)
    want = jax_lib.rmat_edges(n, e, seed, *abc)
    assert native.CALLS["rmat_edges"] == 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64 and a.shape == (e,)
        np.testing.assert_array_equal(a, b)


def test_rmat_edges_range_determinism_and_power_law(lib):
    """The JAX test's checks (tests/test_native.py): ids in range, the same
    seed the same edges, the top 1 % of nodes by in-degree over 5 % of the
    edges; and the second half mirrors the first."""
    s1, d1 = lib.rmat_edges(1000, 5000, seed=42)
    s2, d2 = lib.rmat_edges(1000, 5000, seed=42)
    assert s1.shape == d1.shape == (5000,)
    assert (0 <= s1).all() and (s1 < 1000).all()
    assert (0 <= d1).all() and (d1 < 1000).all()
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(d1, d2)
    deg = np.bincount(d1, minlength=1000)
    assert np.sort(deg)[-10:].sum() > 0.05 * 5000
    half = 5000 // 2 + 1
    np.testing.assert_array_equal(s1[half:], d1[:5000 - half])
    np.testing.assert_array_equal(d1[half:], s1[:5000 - half])
    other = lib.rmat_edges(1000, 5000, seed=43)
    assert not np.array_equal(other[0], s1)


def test_rmat_edges_refuses_bad_arguments(lib):
    for args, kw in (((0, 10), {}), ((10, -1), {}),
                     ((10, 10), dict(seed=-1)), ((10, 10), dict(seed=2 ** 64)),
                     ((10, 10), dict(a=1.5)), ((10, 10), dict(b=-0.1)),
                     ((10, 10), dict(a=0.6, b=0.3, c=0.2))):
        with pytest.raises(ValueError):
            lib.rmat_edges(*args, **kw)
