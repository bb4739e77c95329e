"""The port's naive (edge-materialising) baselines against the JAX
package's, against the port's fused ops, and the naive GAT model against
the flax model with impl="naive"; edge_keep against JAX's bit for bit."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgnn_tpu.models.gat as jax_gat_module
from dgnn_tpu.graph.structure import build_graph as jax_build_graph
from dgnn_tpu.models import GAT as JaxGAT
from dgnn_tpu.ops import common as jcommon
from dgnn_tpu.ops import naive as jnaive
from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.models import GAT, load_flax_gat
from dgnn_tpu_torch.ops import gat_aggregate, gmm_aggregate
from dgnn_tpu_torch.ops.common import edge_keep
from dgnn_tpu_torch.ops.naive import gat_naive, gmm_naive
from tests.conftest import random_graph

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _multigraph(rng, n, deg):
    """Random edges with duplicates left in (the naive baselines sum every
    CSR copy, in both packages)."""
    e = n * deg
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    return (np.concatenate([src, src[:e // 10]]),
            np.concatenate([dst, dst[:e // 10]]))


def _gat_inputs(rng, n, h, f):
    return [rng.normal(size=s).astype(np.float32)
            for s in ((n, h), (n, h), (n, h, f), (n, h, f))]


@pytest.mark.parametrize("p,key_seed", [(0.0, 0), (0.4, 5), (0.4, 11)])
@pytest.mark.parametrize("dense", [None, "auto"])
def test_gat_naive_matches_jax(rng, p, key_seed, dense):
    """Forward and the gradients of (ar, ac, feat), on a multigraph; the
    seed is the one JAX's key gives (jax.random.bits(key, uint32)).  The
    graph's hub block (dense="auto") is not read: naive takes the CSR."""
    n, h, f = 120, 3, 4
    src, dst = _multigraph(rng, n, 6)
    jg = jax_build_graph(src, dst, n, dense=dense)
    tg = build_graph(src, dst, n, dense=dense)
    ar, ac, x, g = _gat_inputs(rng, n, h, f)
    key = jax.random.PRNGKey(key_seed)
    seed = int(jax.random.bits(key, dtype=jnp.uint32))
    want, vjp = jax.vjp(
        lambda a, b, c: jnaive.gat_naive(jg, a, b, c, attn_drop=p, key=key,
                                         training=True),
        *map(jnp.asarray, (ar, ac, x)))
    grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (ar, ac, x)]
    out = gat_naive(tg, *ts, attn_drop=p, seed=seed, training=True)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    for t, gj in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), **BWD_TOL)


@pytest.mark.parametrize("p", [0.0, 0.4])
@pytest.mark.parametrize("power_law", [False, True])
def test_gat_naive_matches_fused_without_hub_block(rng, p, power_law):
    """dense=None: the same function, the same dropped pairs for one seed."""
    n, h, f = 150, 2, 5
    src, dst = random_graph(rng, n, 5, power_law=power_law)
    g = build_graph(src, dst, n, widths=(4, 16))
    ar, ac, x, go = _gat_inputs(rng, n, h, f)
    outs = []
    for fn in (gat_naive, gat_aggregate):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (ar, ac, x)]
        out = fn(g, *ts, attn_drop=p, seed=0xC0FFEE, training=True)
        out.backward(torch.from_numpy(go))
        outs.append([out.detach()] + [t.grad for t in ts])
    torch.testing.assert_close(outs[0][0], outs[1][0], **FWD_TOL)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        torch.testing.assert_close(a, b, **BWD_TOL)


def test_gat_naive_refuses_slim_graph_and_missing_seed(rng):
    src, dst = random_graph(rng, 30, 3)
    g = build_graph(src, dst, 30)
    ar, ac, x, _ = map(torch.from_numpy, _gat_inputs(rng, 30, 1, 2))
    with pytest.raises(ValueError, match="slim"):
        gat_naive(g.slim(), ar, ac, x)
    with pytest.raises(ValueError, match="seed"):
        gat_naive(g, ar, ac, x, attn_drop=0.5, training=True)
    # not training: no dropout, no seed needed
    torch.testing.assert_close(gat_naive(g, ar, ac, x, attn_drop=0.5),
                               gat_naive(g, ar, ac, x))


def test_gmm_naive_matches_jax_and_fused(rng):
    n, k, f, d = 80, 3, 4, 2
    src, dst = random_graph(rng, n, 4)
    jg = jax_build_graph(src, dst, n, widths=(4, 16))
    tg = build_graph(src, dst, n, widths=(4, 16))
    feat = rng.normal(size=(n, k, f)).astype(np.float32)
    pseudo = rng.normal(size=(tg.num_edges, d)).astype(np.float32)
    mu = rng.normal(scale=0.1, size=(k, d)).astype(np.float32)
    isig = (rng.random((k, d)) + 0.5).astype(np.float32)
    g = rng.normal(size=(n, k, f)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: jnaive.gmm_naive(jg, *a),
                        *map(jnp.asarray, (feat, pseudo, mu, isig)))
    grads = vjp(jnp.asarray(g))
    res = {}
    for fn in (gmm_naive, gmm_aggregate):
        ts = [torch.from_numpy(a).requires_grad_(True)
              for a in (feat, pseudo, mu, isig)]
        out = fn(tg, *ts)
        out.backward(torch.from_numpy(g))
        res[fn.__name__] = [out.detach()] + [t.grad for t in ts]
    for name, (out, *tgrads) in res.items():
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   err_msg=name, **FWD_TOL)
        for t, gj in zip(tgrads, grads):
            np.testing.assert_allclose(t.numpy(), np.asarray(gj),
                                       err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("heads,p", [(1, 0.1), (4, 0.3), (7, 0.9)])
def test_edge_keep_bit_equal_jax(rng, heads, p):
    edge = np.concatenate([rng.integers(0, 2 ** 32, 500, dtype=np.uint64),
                           np.array([0, 1, 2 ** 31 - 1, 2 ** 31,
                                     2 ** 32 - 1], np.uint64)])
    for seed in (0, 1, 0x9E3779B9, 2 ** 32 - 1):
        want = jcommon.edge_keep(jnp.uint32(seed),
                                 jnp.asarray(edge.astype(np.uint32)),
                                 heads, p)
        got = edge_keep(seed, torch.from_numpy(edge.astype(np.int64)),
                        heads, p)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float((got == 0).float().mean()) < 1


def _naive_models(rng, n=90, attn_drop=0.3):
    src, dst = _multigraph(rng, n, 4)
    jg = jax_build_graph(src, dst, n)
    tg = build_graph(src, dst, n)
    feat = rng.normal(size=(n, 12)).astype(np.float32)
    kw = dict(num_layers=1, n_hidden=8, n_classes=3, heads=(4, 1),
              feat_drop=0.0, attn_drop=attn_drop)
    jm = JaxGAT(impl="naive", **kw)
    params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(feat))
    tm = GAT(12, 1, 8, 3, (4, 1), feat_drop=0.0, attn_drop=attn_drop,
             impl="naive", generator=torch.Generator().manual_seed(0))
    load_flax_gat(tm, params)
    return jg, tg, feat, jm, params, tm


@pytest.mark.parametrize("training", [False, True])
def test_naive_gat_model_matches_flax(rng, monkeypatch, training):
    """GAT(impl="naive") fed the flax model's params: the flax naive
    model's logits, in eval and with attention dropout 0.3 (the seeds the
    flax model's dropout keys give)."""
    jg, tg, feat, jm, params, tm = _naive_models(rng)
    seeds = []
    orig = jax_gat_module.gat_naive

    def recording(graph, ar, ac, x, **kw):
        assert "gather_dtype" not in kw
        if training:
            seeds.append(int(jax.random.bits(kw["key"], dtype=jnp.uint32)))
        return orig(graph, ar, ac, x, **kw)

    monkeypatch.setattr(jax_gat_module, "gat_naive", recording)
    want = jm.apply(params, jg, jnp.asarray(feat), training=training,
                    rngs={"dropout": jax.random.PRNGKey(5)})
    tm.train(training)
    with torch.no_grad():
        got = tm(tg, torch.from_numpy(feat),
                 attn_seeds=seeds if training else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_gat_refuses_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        GAT(4, 1, 2, 2, (1, 1), impl="dgl")


def _trainer():
    spec = importlib.util.spec_from_file_location(
        "train_gat_torch", ROOT / "scripts" / "train_gat_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dataset", ["cora", "pubmed"])
def test_trainer_naive_on_cpu(tmp_path, capsys, dataset):
    """--impl naive trains on the raw CSR (the graph is not slimmed), and
    its CSV row is named after it."""
    trainer = _trainer()
    out = tmp_path / "rows.csv"
    args = trainer.parser().parse_args(
        ["--device", "cpu", "--dataset", dataset, "--impl", "naive",
         "--n-epochs", "5", "--n-heads", "2", "--n-hidden", "8",
         "--attn-drop", "0.3", "--output", str(out)])
    r = trainer.run(args)
    g = r["graph"]
    assert g.row_ptr.shape[0] == g.num_nodes + 1
    assert g.col_ind.shape[0] == g.num_edges
    assert len(r["losses"]) == 5 and np.isfinite(r["losses"]).all()
    assert all(c.impl == "naive" for c in r["model"].convs.values())
    assert "train_GAT_dgnn_tpu_torch_naive," in out.read_text()
    assert "Test Accuracy" in capsys.readouterr().out
