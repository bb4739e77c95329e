"""The port's flat primitives (spmm, sddmm, edge_softmax, edge_transpose)
against dgnn_tpu.ops.primitives on the same numpy inputs, forward and
gradients, and against the port's dense oracles (ops/reference.py)."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgnn_tpu.graph.structure import build_graph as jax_build_graph
from dgnn_tpu.ops import primitives as jprim
from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.ops import edge_softmax, edge_transpose, reference
from dgnn_tpu_torch.ops import sddmm, spmm
from tests.conftest import random_graph

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAPHS = [dict(power_law=False, widths=(4, 16)),
          dict(power_law=True, widths=(4, 16)),
          dict(power_law=True, widths=None)]


def _graphs(rng, n=60, deg=4, power_law=False, widths=(4, 16),
            self_loops=True):
    src, dst = random_graph(rng, n, deg, power_law=power_law)
    kw = dict(widths=widths, self_loops=self_loops)
    return jax_build_graph(src, dst, n, **kw), build_graph(src, dst, n, **kw)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(True)


@pytest.mark.parametrize("kw", GRAPHS)
def test_spmm_matches_jax_and_oracle(rng, kw):
    jg, tg = _graphs(rng, **kw)
    n, h, f = tg.num_nodes, 2, 5
    w = rng.normal(size=(tg.num_edges, h)).astype(np.float32)
    x = rng.normal(size=(n, h, f)).astype(np.float32)
    g = rng.normal(size=(n, h, f)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jprim.spmm(jg, a, b), jnp.asarray(w),
                        jnp.asarray(x))
    dw_j, dx_j = vjp(jnp.asarray(g))
    tw, tx = _t(w), _t(x)
    out = spmm(tg, tw, tx)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_j), **BWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx_j), **BWD_TOL)
    # the dense oracle: gmm_dense's edge-id table, weights per (dst, src)
    eid = torch.from_numpy(reference.dense_edge_ids(
        tg.row_ptr.numpy(), tg.col_ind.numpy(), n))
    wd = torch.where((eid >= 0)[..., None],
                     torch.from_numpy(w)[eid.clamp(min=0)], 0.0)
    np.testing.assert_allclose(
        out.detach().numpy(),
        torch.einsum("dsh,shf->dhf", wd, torch.from_numpy(x)).numpy(),
        **FWD_TOL)


@pytest.mark.parametrize("kw", GRAPHS)
def test_sddmm_matches_jax_and_oracle(rng, kw):
    jg, tg = _graphs(rng, **kw)
    n, h, f = tg.num_nodes, 3, 4
    a = rng.normal(size=(n, h, f)).astype(np.float32)
    b = rng.normal(size=(n, h, f)).astype(np.float32)
    g = rng.normal(size=(tg.num_edges, h)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, q: jprim.sddmm(jg, p, q), jnp.asarray(a),
                        jnp.asarray(b))
    da_j, db_j = vjp(jnp.asarray(g))
    ta, tb = _t(a), _t(b)
    out = sddmm(tg, ta, tb)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(da_j), **BWD_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(db_j), **BWD_TOL)
    rows = np.repeat(np.arange(n), np.diff(tg.row_ptr.numpy()))
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.einsum("ehf,ehf->eh", a[rows], b[tg.col_ind.numpy()]), **FWD_TOL)


@pytest.mark.parametrize("kw", GRAPHS)
def test_edge_softmax_matches_jax_and_sums_to_one(rng, kw):
    jg, tg = _graphs(rng, n=80, deg=2, self_loops=False, **kw)
    s = (3 * rng.normal(size=(tg.num_edges, 2))).astype(np.float32)
    g = rng.normal(size=(tg.num_edges, 2)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jprim.edge_softmax(jg, x), jnp.asarray(s))
    (ds_j,) = vjp(jnp.asarray(g))
    ts = _t(s)
    out = edge_softmax(tg, ts)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(ds_j), **BWD_TOL)
    rp = tg.row_ptr.numpy()
    sums = np.zeros((tg.num_nodes, 2), np.float32)
    np.add.at(sums, np.repeat(np.arange(tg.num_nodes), np.diff(rp)),
              out.detach().numpy())
    full = np.diff(rp) > 0
    assert not full.all()  # a node with no in-edge: its row stays empty
    np.testing.assert_allclose(sums[full], 1.0, rtol=1e-5)


def test_edge_transpose_matches_jax(rng):
    jg, tg = _graphs(rng)
    data = rng.normal(size=(tg.num_edges, 3)).astype(np.float32)
    got = edge_transpose(tg, torch.from_numpy(data))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jprim.edge_transpose(jg, jnp.asarray(data))))
    np.testing.assert_array_equal(got.numpy(),
                                  data[tg.permute.numpy()])


def test_flat_primitives_refuse_unfit_graphs(rng):
    """A hub block (its edges have no ids), no edge tables, a slim graph."""
    src, dst = random_graph(rng, 300, 5, power_law=True)
    hub = build_graph(src, dst, 300, dense=(64, 150))
    x = torch.zeros((300, 1, 2))
    w = torch.zeros((hub.num_edges, 1))
    with pytest.raises(ValueError, match="dense=None"):
        spmm(hub, w, x)
    with pytest.raises(ValueError, match="dense=None"):
        sddmm(hub, x, x)
    bare = build_graph(src, dst, 300, edge_tables=False)
    with pytest.raises(ValueError, match="edge_tables=True"):
        spmm(bare, w, x)
    slim = build_graph(src, dst, 300).slim()
    with pytest.raises(ValueError, match="slim"):
        edge_softmax(slim, w)
    with pytest.raises(ValueError, match="slim"):
        edge_transpose(slim, w)
