"""The port's dense oracles (ops/reference.py) against
dgnn_tpu.ops.reference on the same numpy inputs."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgnn_tpu.ops import reference as jref
from dgnn_tpu_torch.graph.build import coo_to_csr
from dgnn_tpu_torch.ops import reference
from tests.conftest import random_graph

TOL = dict(rtol=1e-5, atol=1e-5)


def _csr(rng, n=40, deg=3):
    src, dst = random_graph(rng, n, deg)
    return coo_to_csr(src, dst, n)


def test_dense_adj_and_edge_ids_equal_jax(rng):
    rp, ci = _csr(rng)
    np.testing.assert_array_equal(reference.dense_adj(rp, ci, 40),
                                  jref.dense_adj(rp, ci, 40))
    got = reference.dense_edge_ids(rp, ci, 40)
    np.testing.assert_array_equal(got, jref.dense_edge_ids(rp, ci, 40))
    assert (got >= 0).sum() == ci.shape[0]


@pytest.mark.parametrize("p,ids", [(0.0, False), (0.4, False), (0.4, True)])
def test_gat_dense_matches_jax(rng, p, ids):
    """With dropout on the positional ids and on ids the caller gives (a
    shard's global ids)."""
    n, h, f = 40, 3, 5
    rp, ci = _csr(rng, n)
    adj = reference.dense_adj(rp, ci, n)
    adj[5] = False  # an empty row
    ar, ac = (rng.normal(size=(n, h)).astype(np.float32) for _ in range(2))
    feat = rng.normal(size=(n, h, f)).astype(np.float32)
    seed = 0xDEADBEEF
    kw = dict(attn_drop=p)
    if ids:
        kw.update(dst_ids=rng.permutation(1000)[:n] + 7,
                  src_ids=rng.permutation(1000)[:n] + 900)
    want = jref.gat_dense(adj, jnp.asarray(ar), jnp.asarray(ac),
                          jnp.asarray(feat), seed=jnp.uint32(seed), **kw)
    got = reference.gat_dense(adj, torch.from_numpy(ar),
                              torch.from_numpy(ac), torch.from_numpy(feat),
                              seed=seed, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert np.isneginf(got[1][5].numpy()).all()


def test_gmm_dense_matches_jax(rng):
    n, k, f, d = 30, 3, 4, 2
    rp, ci = _csr(rng, n)
    eid = reference.dense_edge_ids(rp, ci, n)
    feat = rng.normal(size=(n, k, f)).astype(np.float32)
    pseudo = rng.normal(size=(ci.shape[0], d)).astype(np.float32)
    mu = rng.normal(scale=0.5, size=(k, d)).astype(np.float32)
    isig = (rng.random((k, d)) + 0.5).astype(np.float32)
    want = jref.gmm_dense(eid, *map(jnp.asarray, (feat, pseudo, mu, isig)))
    got = reference.gmm_dense(eid, *map(torch.from_numpy,
                                        (feat, pseudo, mu, isig)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_edgeconv_dense_matches_jax(rng):
    n, k, f = 50, 6, 7
    nbr = rng.integers(0, n, (n, k))
    hs, hd = (rng.normal(size=(n, f)).astype(np.float32) for _ in range(2))
    want = jref.edgeconv_dense(nbr, jnp.asarray(hs), jnp.asarray(hd))
    got = reference.edgeconv_dense(nbr, torch.from_numpy(hs),
                                   torch.from_numpy(hd))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
