"""The port's reddit path on the host: the graph cache (the JAX package's
files load equal to the port's own build; the port's files round-trip),
``structure_task_from_csr`` and the raw builder against the JAX package's,
``Graph.out_degrees``, and both trainers' ``--dataset reddit`` branch on
the CPU at a cut scale."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from dgnn_tpu.data import synthetic as jsynthetic
from dgnn_tpu.graph import cache as jcache
from dgnn_tpu.graph import structure as jstructure
from dgnn_tpu_torch.data import reddit, synthetic
from dgnn_tpu_torch.graph import cache, structure
from test_torch_graph import _assert_adj_equal
from tests.conftest import random_graph

ROOT = pathlib.Path(__file__).resolve().parents[1]
RAW_KEYS = ("row_ptr", "col_ind", "col_ptr", "row_ind", "permute")
# A reddit cut to 46 nodes and 22,923 edges: enough nodes for its 41
# classes, both directions keep a hub block.
SCALE = 2e-4


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_graph_equal(t, j):
    """A port Graph against another Graph (either package's), array for
    array."""
    assert (t.num_nodes, t.num_edges) == (j.num_nodes, j.num_edges)
    for key in RAW_KEYS:
        tv = getattr(t, key)
        assert tv.dtype == torch.int32, key
        np.testing.assert_array_equal(tv.numpy(), np.asarray(getattr(j, key)),
                                      err_msg=key)
    _assert_adj_equal(t.fwd, j.fwd)
    _assert_adj_equal(t.bwd, j.bwd)


@pytest.mark.parametrize("dense,edge_tables", [
    ("auto", False), ("auto", True), (None, True), ((256, 2048), False)])
def test_jax_cache_file_loads_equal_to_the_ports_build(tmp_path, dense,
                                                       edge_tables):
    """Cora keeps a hub block in both directions under "auto"; without one
    and with edge tables the bins carry epos."""
    d = synthetic.synthetic_citation("cora")
    j = jstructure.build_graph(d.src, d.dst, d.num_nodes, dense=dense,
                               edge_tables=edge_tables)
    path = str(tmp_path / "jax.npz")
    jcache.save_graph(path, j)
    got = cache.load_graph(path)
    want = structure.build_graph(d.src, d.dst, d.num_nodes, dense=dense,
                                 edge_tables=edge_tables)
    assert (want.fwd.dense is not None) == (dense is not None)
    assert (want.fwd.epos is not None) == (dense is None and edge_tables)
    _assert_graph_equal(got, want)
    _assert_graph_equal(got, j)


@pytest.mark.parametrize("slim", [False, True])
def test_port_cache_round_trip(tmp_path, rng, slim):
    src, dst = random_graph(rng, 400, 6, power_law=True)
    g = structure.build_graph(src, dst, 400, dense=(64, 300))
    assert g.fwd.dense is not None and g.bwd.dense is not None
    if slim:
        g = g.slim()
    path = str(tmp_path / "g.npz")
    cache.save_graph(path, g)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["g.npz"]
    _assert_graph_equal(cache.load_graph(path), g)


def test_port_cache_file_has_the_jax_layout(tmp_path, rng):
    """The port writes the _d6 keys the JAX package writes, less the hub
    block's half schedule (a TPU layout the port does not build)."""
    src, dst = random_graph(rng, 300, 5, power_law=True)
    kw = dict(widths=(4, 16), dense=(64, 150))
    cache.save_graph(str(tmp_path / "t.npz"),
                     structure.build_graph(src, dst, 300, **kw))
    jcache.save_graph(str(tmp_path / "j.npz"),
                      jstructure.build_graph(src, dst, 300, **kw))
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        half = {k for k in j.files if k.endswith(("_rc_h", "_ct_h",
                                                  "_first_h", "_mt_h"))}
        assert half and set(t.files) == set(j.files) - half
        for key in t.files:
            if key != "meta_json":
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)


@pytest.mark.parametrize("self_loops", [True, False])
def test_out_degrees_match_jax(rng, self_loops):
    src, dst = random_graph(rng, 120, 4, power_law=True)
    t = structure.build_graph(src, dst, 120, self_loops=self_loops)
    j = jstructure.build_graph(src, dst, 120, self_loops=self_loops)
    deg = t.out_degrees()
    assert deg.dtype == torch.int32 and deg.shape == (120,)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(j.out_degrees()))
    assert int(deg.sum()) == t.num_edges
    np.testing.assert_array_equal(deg.numpy(),
                                  np.bincount(t.col_ind.numpy(),
                                              minlength=120))


@pytest.mark.parametrize("n,e,c,f,seed", [(500, 4000, 7, 16, 0),
                                          (2000, 20000, 41, 8, 3),
                                          (60, 0, 5, 4, 1)])
def test_structure_task_matches_jax(n, e, c, f, seed):
    """Including a graph with no edges (random labels)."""
    if e:
        s, d = synthetic.rmat_edges(n, e, seed=seed)
    else:
        s = d = np.zeros(0, np.int64)
    g = structure.build_graph(s, d, n, self_loops=False)
    rp, ci = g.row_ptr.numpy(), g.col_ind.numpy()
    got = synthetic.structure_task_from_csr(rp, ci, c, f, seed=seed)
    want = jsynthetic.structure_task_from_csr(rp, ci, c, f, seed=seed)
    for name, x, y in zip(("features", "labels", "train", "val", "test"),
                          got, want):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert got[4].any()


def test_build_raw_matches_jax(tmp_path):
    ref = _load("build_reddit_raw")
    ours = _load("build_reddit_raw_torch")
    n, e = reddit.reddit_size(SCALE)
    ref.build_raw(n, e, str(tmp_path / "j.npz"))
    ours.build_raw(n, e, str(tmp_path / "t.npz"))
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert set(t.files) == set(j.files)
        for key in j.files:
            assert t[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)


def test_build_raw_cli_writes_the_trainers_cache_file(tmp_path, capsys):
    ours = _load("build_reddit_raw_torch")
    out = tmp_path / "raw.npz"
    ours.main([str(out), "--scale", str(SCALE)])
    printed = capsys.readouterr().out
    assert "rmat edges" in printed and "csc+permute" in printed
    n, e = reddit.reddit_size(SCALE)
    with np.load(out) as z:
        assert z["row_ptr"].shape == (n + 1,)
    assert (n, e) == (46, 22923)


def test_load_reddit_builds_then_reads_its_cache(tmp_path):
    first = reddit.load_reddit(SCALE, cache_dir=tmp_path, log=lambda m: None)
    assert "bins + hub block" in first.seconds
    n, e = reddit.reddit_size(SCALE)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"rmat_graph_{n}_{e}_d6_{reddit.graph_key()}_torch.npz",
                     f"rmat_raw_{n}_{e}_torch.npz"]
    g = first.graph
    assert g.num_nodes == n and g.fwd.dense is not None \
        and g.bwd.dense is not None
    assert first.features.shape == (n, 602) and first.n_classes == 41
    again = reddit.load_reddit(SCALE, cache_dir=tmp_path, log=lambda m: None)
    assert set(again.seconds) == {"cache load", "task"}
    _assert_graph_equal(again.graph, g)
    for x, y in ((again.features, first.features),
                 (again.labels, first.labels),
                 (again.test_mask, first.test_mask)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["gat", "gmm"])
def test_trainers_reddit_branch_on_cpu(tmp_path, capsys, kind):
    """The reddit protocol at a cut scale: the port's cache, the task from
    the graph's own edges, slimmed graph, node pseudo and bf16 gathers for
    MoNet (the JAX CLI's), bf16 gathers for GAT when asked."""
    trainer = _load(f"train_{kind}_torch")
    argv = ["--dataset", "reddit", "--scale", str(SCALE), "--cache-dir",
            str(tmp_path), "--device", "cpu", "--n-epochs", "5",
            "--n-hidden", "16"]
    argv += (["--n-heads", "4", "--gather-dtype", "bfloat16"]
             if kind == "gat" else ["--n-kernels", "2"])
    r = trainer.run(trainer.parser().parse_args(argv))
    g = r["graph"]
    assert g.row_ptr.numel() == 0  # slimmed
    assert g.fwd.dense is not None and g.bwd.dense is not None
    assert r["logits"].shape == (46, 41)
    assert np.isfinite(r["losses"]).all()
    assert "bins + hub block" in r["setup_s"]
    if kind == "gmm":
        assert r["pseudo_mode"] == "node" and r["gather_dtype"] == "bfloat16"
    convs = r["model"].convs.values()
    assert all(c.gather_dtype == "bfloat16" for c in convs)
    assert "Test Accuracy" in capsys.readouterr().out
