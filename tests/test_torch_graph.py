"""The port's host layer against the JAX package's: synthetic data, degree
bins, combine tables, hub planning and the hub block must be identical."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import numpy as np
import pytest
import torch

from dgnn_tpu.data import synthetic as jsynthetic
from dgnn_tpu.graph import hub as jhub
from dgnn_tpu.graph import structure as jstructure
from dgnn_tpu_torch.data import synthetic
from dgnn_tpu_torch.graph import build as tbuild
from dgnn_tpu_torch.graph import hub, structure
from tests.conftest import random_graph


@pytest.mark.parametrize("name", ["cora", "pubmed"])
def test_synthetic_citation_identical(name):
    a = synthetic.synthetic_citation(name, seed=3)
    b = jsynthetic.synthetic_citation(name, seed=3)
    for field in ("src", "dst", "features", "labels", "train_mask",
                  "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)
    assert (a.num_nodes, a.n_classes) == (b.num_nodes, b.n_classes)


def test_rmat_edges_identical():
    for x, y in zip(synthetic.rmat_edges(500, 4000, seed=2),
                    jsynthetic.rmat_edges(500, 4000, seed=2)):
        np.testing.assert_array_equal(x, y)


def _assert_adj_equal(t, j):
    assert t.widths == j.widths
    assert (t.num_rows, t.num_edges) == (j.num_rows, j.num_edges)
    for b in range(len(j.widths)):
        for key in ("nbr", "row", "count", "edge"):
            tv, jv = getattr(t, key)[b], getattr(j, key)[b]
            if jv is None:
                assert tv is None
                continue
            assert tv.dtype == torch.int32
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                          err_msg=f"{key}[{b}]")
    if j.cmb is None:
        assert t.cmb is None
    else:
        for key in ("main", "ov_rows", "ov"):
            np.testing.assert_array_equal(getattr(t.cmb, key).numpy(),
                                          np.asarray(getattr(j.cmb, key)),
                                          err_msg=key)
    if j.epos is None:
        assert t.epos is None
    else:
        np.testing.assert_array_equal(t.epos.numpy(), np.asarray(j.epos))
    if j.dense is None:
        assert t.dense is None
        return
    for key in ("row_ids", "col_ids", "mask", "rc", "ct", "first"):
        tv = getattr(t.dense, key)
        assert tv.dtype == (torch.uint8 if key == "mask" else torch.int32)
        np.testing.assert_array_equal(tv.numpy(),
                                      np.asarray(getattr(j.dense, key)),
                                      err_msg=f"dense.{key}")
    assert t.dense.num_rows == j.dense.num_rows
    starts = np.flatnonzero(t.dense.first.numpy())
    np.testing.assert_array_equal(t.dense.chunk_ptr.numpy(),
                                  np.append(starts, len(t.dense.first)))


@pytest.mark.parametrize("power_law,widths,self_loops", [
    (False, None, True),
    (True, None, True),
    (True, (4, 16), True),
    (False, (2, 8), False),
])
def test_build_graph_identical(rng, power_law, widths, self_loops):
    n = 300
    src, dst = random_graph(rng, n, 5, power_law=power_law)
    t = structure.build_graph(src, dst, n, widths=widths,
                              self_loops=self_loops)
    j = jstructure.build_graph(src, dst, n, widths=widths,
                               self_loops=self_loops)
    for key in ("row_ptr", "col_ind", "col_ptr", "row_ind", "permute"):
        np.testing.assert_array_equal(getattr(t, key).numpy(),
                                      np.asarray(getattr(j, key)))
    _assert_adj_equal(t.fwd, j.fwd)
    _assert_adj_equal(t.bwd, j.bwd)
    slim = t.slim()
    assert slim.row_ptr.numel() == 0 and slim.fwd is t.fwd


def test_pubmed_plan_and_layout_identical():
    """Pubmed keeps no hub block in either package, so both bin the whole
    graph; its combine tables have overflow rows."""
    d = synthetic.synthetic_citation("pubmed")
    src, dst = tbuild.remove_self_loops(d.src, d.dst)
    src, dst = tbuild.add_self_loops(src, dst, d.num_nodes)
    rp, ci = tbuild.coo_to_csr(src, dst, d.num_nodes)
    cp, ri, _ = tbuild.csr_to_csc_permute(rp, ci)
    for args in ((rp, ci, np.diff(cp)), (cp, ri, np.diff(rp))):
        assert hub.plan_dense(*args) is None
        assert jhub.plan_dense(*args) is None
    t = structure.build_graph(d.src, d.dst, d.num_nodes, dense="auto",
                              edge_tables=False)
    j = jstructure.build_graph(d.src, d.dst, d.num_nodes, dense="auto",
                               edge_tables=False)
    _assert_adj_equal(t.fwd, j.fwd)
    _assert_adj_equal(t.bwd, j.bwd)
    assert t.fwd.cmb.ov_rows.shape[0] > 0 and t.bwd.cmb.ov_rows.shape[0] > 0


@pytest.mark.parametrize("dense", ["auto", (256, 2048)])
def test_cora_hub_block_refused(dense):
    """Cora's hub block (the name dates from when the port refused it) is
    planned and built as the JAX package builds it, in both directions:
    the dense block, the residual bins and the combine tables."""
    d = synthetic.synthetic_citation("cora")
    rp, ci = tbuild.coo_to_csr(*tbuild.add_self_loops(
        *tbuild.remove_self_loops(d.src, d.dst), d.num_nodes), d.num_nodes)
    cp, _, _ = tbuild.csr_to_csc_permute(rp, ci)
    ours = hub.plan_dense(rp, ci, np.diff(cp))
    theirs = jhub.plan_dense(rp, ci, np.diff(cp))
    assert ours is not None and theirs is not None
    for x, y in zip(ours, theirs):
        np.testing.assert_array_equal(x, y)
    t = structure.build_graph(d.src, d.dst, d.num_nodes, dense=dense)
    j = jstructure.build_graph(d.src, d.dst, d.num_nodes, dense=dense)
    for adj_t, adj_j in ((t.fwd, j.fwd), (t.bwd, j.bwd)):
        assert adj_t.dense is not None
        _assert_adj_equal(adj_t, adj_j)
    # the block's rows are valid entries of the combine table
    assert t.fwd.cmb.main.max() >= sum(x.shape[0] for x in t.fwd.nbr)


@pytest.mark.parametrize("self_loops", [True, False])
def test_degrees_match_jax(rng, self_loops):
    src, dst = random_graph(rng, 120, 4, power_law=True)
    t = structure.build_graph(src, dst, 120, self_loops=self_loops)
    j = jstructure.build_graph(src, dst, 120, self_loops=self_loops)
    deg = t.in_degrees()
    assert deg.dtype == torch.int32 and deg.shape == (120,)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(j.in_degrees()))
    assert int(deg.sum()) == t.num_edges
    assert (int(deg.min()) == 0) == (not self_loops)


def test_graph_to_moves_every_table(rng):
    src, dst = random_graph(rng, 50, 3)
    g = structure.build_graph(src, dst, 50).to("cpu")
    assert g.fwd.cmb.main.device.type == "cpu"
    assert all(n.device.type == "cpu" for n in g.bwd.nbr)


def test_segs_are_the_bins_slot_tables(rng):
    """segs() gives each bin's (nbr, row, count), the tensors themselves,
    in bin order, for both directions."""
    src, dst = random_graph(rng, 80, 4)
    g = structure.build_graph(src, dst, 80, widths=(4, 8, 16))
    for adj in (g.fwd, g.bwd):
        segs = adj.segs()
        assert len(segs) == adj.num_bins > 1
        for seg, (_w, nbr, _e, row, count) in zip(segs, adj.bins()):
            assert seg[0] is nbr and seg[1] is row and seg[2] is count


@pytest.mark.parametrize("with_edge", [True, False])
@pytest.mark.parametrize("block", [None, (64, 150)])
def test_from_binned_without_combine_table(rng, with_edge, block):
    """from_binned(with_cmb=False) builds the JAX package's arrays, array for
    array, without a combine table; the fused ops refuse such a graph."""
    import dataclasses

    from dgnn_tpu.graph import binning as jbinning
    from dgnn_tpu_torch.graph import binning
    from dgnn_tpu_torch.ops.gat import gat_aggregate
    from dgnn_tpu_torch.ops.gmm import gmm_aggregate_node

    n = 300
    src, dst = random_graph(rng, n, 5, power_law=True)
    rp, ci = tbuild.coo_to_csr(src, dst, n)
    cp, _, _ = tbuild.csr_to_csc_permute(rp, ci)
    plan = jplan = None
    if block is not None:
        rows = np.argsort(np.diff(rp), kind="stable")[::-1][:block[0]]
        cols = np.argsort(np.diff(cp), kind="stable")[::-1][:block[1]]
        plan, rp_t, ci_t, keep = hub.build_dense_numpy(rp, ci, rows, cols)
        jplan, rp_j, ci_j, _ = jhub.build_dense_numpy(rp, ci, rows, cols)
        eids = np.arange(len(ci), dtype=np.int64)[keep]
    else:
        rp_t, ci_t = rp_j, ci_j = rp, ci
        eids = None
    t = structure.from_binned(binning.bin_csr(rp_t, ci_t, edge_ids=eids),
                              with_cmb=False, with_edge=with_edge,
                              dense=plan)
    j = jstructure.from_binned(jbinning.bin_csr(rp_j, ci_j, edge_ids=eids),
                               with_cmb=False, with_edge=with_edge,
                               dense=jplan)
    assert t.cmb is None and j.cmb is None
    _assert_adj_equal(t, j)
    g = structure.build_graph(src, dst, n, dense=block)
    g = dataclasses.replace(g, fwd=dataclasses.replace(g.fwd, cmb=None))
    x = torch.zeros((n, 1, 2))
    with pytest.raises(ValueError, match="combine tables"):
        gat_aggregate(g, torch.zeros((n, 1)), torch.zeros((n, 1)), x)
    with pytest.raises(ValueError, match="combine tables"):
        gmm_aggregate_node(g, x, torch.zeros((n, 1)), torch.zeros((n, 1)),
                           torch.zeros((1, 2)), torch.ones((1, 2)),
                           proj_weight=torch.zeros((2, 2)),
                           proj_bias=torch.zeros(2))
