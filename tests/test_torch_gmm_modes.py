"""MoNet's binned and flat pseudo-coordinate modes: ``gmm_aggregate_binned``
and the flat ``gmm_aggregate`` against the JAX ops (forward and every
gradient), ``MoNet`` in all three modes against the flax model on converted
weights, and the MoNet CLI's default set-up against the JAX CLI's.

Neither mode reaches a Pallas kernel in the JAX package, and the port's
versions are plain PyTorch, so everything here runs on the CPU.  Tolerance:
rtol 2e-4 / atol 2e-5, float32 sums over every edge in another order.
"""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgnn_tpu.graph.structure import build_graph as jax_build_graph
from dgnn_tpu.models import MoNet as JaxMoNet
from dgnn_tpu.ops import gmm as jgmm
from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.models import MoNet, load_flax_monet
from dgnn_tpu_torch.models.monet import GMMConv
from dgnn_tpu_torch.ops import gmm as tgmm

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-5)
N = 200


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _edges(rng, n, avg_degree):
    """Deduplicated random COO edges with Zipf-skewed destinations (a bin
    wider than the rest, split rows)."""
    e = int(n * avg_degree)
    src = rng.integers(0, n, e)
    dst = np.minimum(rng.zipf(1.6, e) - 1, n - 1)
    uniq = np.unique(np.stack([src, dst], 1), axis=0)
    return uniq[:, 0], uniq[:, 1]


def _graphs(rng, widths=(4, 16)):
    src, dst = _edges(rng, N, 4)
    jg = jax_build_graph(src, dst, N, widths=widths)
    tg = build_graph(src, dst, N, widths=widths)
    assert tg.fwd.epos is not None and tg.fwd.dense is None
    return jg, tg


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("proj,use_tanh,d", [
    (True, True, 2), (True, False, 2), (True, True, 3), (False, False, 2),
    (False, True, 3)])
def test_binned_op_forward_and_grads_match_jax(rng, proj, use_tanh, d):
    """With the in-op projection (tanh on and off, D = Din and D > Din)
    and without it (the identity, where use_tanh is ignored as in JAX)."""
    jg, tg = _graphs(rng)
    k, f, din = 2, 5, 2
    a = dict(feat=rng.normal(size=(N, k, f)), mu=rng.normal(size=(k, d)),
             isig=rng.random((k, d)) + 0.5, pw=rng.normal(size=(din, d)),
             pb=rng.normal(size=(d,)), ct=rng.normal(size=(N, k, f)),
             praw=rng.normal(size=(tg.num_edges, din)))
    a = {n: v.astype(np.float32) for n, v in a.items()}
    names = ("feat", "mu", "isig") + (("pw", "pb") if proj else ())
    pj = jgmm.bin_pseudo(jg, jnp.asarray(a["praw"]))

    @jax.jit
    def out_and_grads(g, pj, ct, *xs):
        def fn(*xs):
            kw = dict(zip(names, xs))
            return jgmm.gmm_aggregate_binned(
                g, kw["feat"], pj, kw["mu"], kw["isig"],
                proj_weight=kw.get("pw"), proj_bias=kw.get("pb"),
                use_tanh=use_tanh)
        out, vjp = jax.vjp(fn, *xs)
        return out, vjp(ct)

    out_j, grads_j = out_and_grads(jg, pj, jnp.asarray(a["ct"]),
                                   *(jnp.asarray(a[n]) for n in names))
    ts = {n: torch.from_numpy(a[n]).requires_grad_(True) for n in names}
    pt = tgmm.bin_pseudo(tg, torch.from_numpy(a["praw"]))
    out_t = tgmm.gmm_aggregate_binned(
        tg, ts["feat"], pt, ts["mu"], ts["isig"], proj_weight=ts.get("pw"),
        proj_bias=ts.get("pb"), use_tanh=use_tanh)
    out_t.backward(torch.from_numpy(a["ct"]))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               err_msg="out", **TOL)
    for name, gj in zip(names, grads_j):
        np.testing.assert_allclose(ts[name].grad.numpy(), np.asarray(gj),
                                   err_msg=name, **TOL)


def test_bin_pseudo_matches_jax(rng):
    jg, tg = _graphs(rng)
    praw = rng.normal(size=(tg.num_edges, 2)).astype(np.float32)
    for tt, jt in zip(tgmm.bin_pseudo(tg, torch.from_numpy(praw)),
                      jgmm.bin_pseudo(jg, jnp.asarray(praw))):
        assert len(tt) == len(jt)
        for x, y in zip(tt, jt):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_flat_op_forward_and_grads_match_jax(rng):
    jg, tg = _graphs(rng)
    k, f, d = 3, 4, 2
    a = dict(feat=rng.normal(size=(N, k, f)), mu=rng.normal(size=(k, d)),
             isig=rng.random((k, d)) + 0.5,
             pseudo=rng.normal(size=(tg.num_edges, d)),
             ct=rng.normal(size=(N, k, f)))
    a = {n: v.astype(np.float32) for n, v in a.items()}
    names = ("feat", "pseudo", "mu", "isig")

    @jax.jit
    def out_and_grads(g, ct, feat, pseudo, mu, isig):
        out, vjp = jax.vjp(lambda *xs: jgmm.gmm_aggregate(g, *xs), feat,
                           pseudo, mu, isig)
        return out, vjp(ct)

    out_j, grads_j = out_and_grads(jg, jnp.asarray(a["ct"]),
                                   *(jnp.asarray(a[n]) for n in names))
    ts = {n: torch.from_numpy(a[n]).requires_grad_(True) for n in names}
    out_t = tgmm.gmm_aggregate(tg, *(ts[n] for n in names))
    out_t.backward(torch.from_numpy(a["ct"]))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               err_msg="out", **TOL)
    for name, gj in zip(names, grads_j):
        np.testing.assert_allclose(ts[name].grad.numpy(), np.asarray(gj),
                                   err_msg=name, **TOL)


def test_flat_and_binned_refuse_graphs_without_edge_tables(rng):
    src, dst = _edges(rng, N, 4)
    g = build_graph(src, dst, N, edge_tables=False)
    feat = torch.zeros((N, 2, 3))
    mu = isig = torch.ones((2, 2))
    with pytest.raises(ValueError, match="edge_tables=True"):
        tgmm.gmm_aggregate(g, feat, torch.zeros((g.num_edges, 2)), mu, isig)
    with pytest.raises(ValueError, match="edge_tables=True"):
        tgmm.bin_pseudo(g, torch.zeros((g.num_edges, 2)))
    hub = build_graph(src, dst, N, dense=(64, 150))
    with pytest.raises(ValueError, match="edge_tables=True"):
        tgmm.gmm_aggregate(hub, feat, torch.zeros((hub.num_edges, 2)), mu,
                           isig)


def _pseudo_forms(rng, jg, tg):
    """The same pseudo-coordinates for both packages, per mode: the node
    columns, the binned raw tables, the flat raw [E, 2]."""
    rsq = (1.0 / np.sqrt(np.maximum(np.diff(tg.row_ptr.numpy()), 1))
           ).astype(np.float32)[:, None]
    praw = rng.normal(size=(tg.num_edges, 2)).astype(np.float32)
    return {
        "node": (jgmm.NodePseudo(src=jnp.asarray(rsq), dst=jnp.asarray(rsq)),
                 tgmm.NodePseudo(src=torch.from_numpy(rsq),
                                 dst=torch.from_numpy(rsq))),
        "binned": (jgmm.bin_pseudo(jg, jnp.asarray(praw)),
                   tgmm.bin_pseudo(tg, torch.from_numpy(praw))),
        "flat": (jnp.asarray(praw), torch.from_numpy(praw)),
    }


@pytest.mark.parametrize("mode", ["node", "binned", "flat"])
def test_converted_monet_matches_flax_in_every_mode(rng, mode):
    """Flax MoNet (2 GMMConv layers) -> load_flax_monet: equal logits in
    eval mode and equal parameter gradients (dropout 0)."""
    import optax

    jg, tg = _graphs(rng)
    feat = rng.normal(size=(N, 12)).astype(np.float32)
    labels = rng.integers(0, 3, N)
    jp, tp = _pseudo_forms(rng, jg, tg)[mode]
    jm = JaxMoNet(n_hidden=8, out_feats=3, n_layers=1, dim=2, n_kernels=2,
                  dropout=0.0)
    params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(feat), jp)
    tm = MoNet(12, 8, 3, 1, 2, 2, dropout=0.0, pseudo=mode,
               generator=torch.Generator().manual_seed(0))
    load_flax_monet(tm, params)

    def loss_fn(p):
        logits = jm.apply(p, jg, jnp.asarray(feat), jp, training=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    tm.eval()
    with torch.no_grad():
        got = tm(tg, torch.from_numpy(feat), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tm.train()
    logits = tm(tg, torch.from_numpy(feat), tp)
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels).long()).backward()
    from dgnn_tpu_torch.models import flax_monet_state_dict
    want_grads = flax_monet_state_dict(grads)
    assert set(want_grads) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want_grads[name].numpy(), err_msg=name,
                                   rtol=2e-4, atol=1e-5)


def test_monet_refuses_a_pseudo_of_another_mode(rng):
    jg, tg = _graphs(rng)
    forms = _pseudo_forms(rng, jg, tg)
    x = torch.zeros((N, 12))
    for mode in ("node", "binned", "flat"):
        tm = MoNet(12, 8, 3, 1, 2, 2, pseudo=mode)
        for other in set(forms) - {mode}:
            with pytest.raises(TypeError, match=mode):
                tm(tg, x, forms[other][1])
    with pytest.raises(ValueError, match="pseudo"):
        MoNet(12, 8, 3, 1, 2, 2, pseudo="edge")
    with pytest.raises(ValueError, match="pseudo_proj=True"):
        GMMConv(12, 8, 2, 2, pseudo_proj=False)(tg, x, forms["node"][1])
    with pytest.raises(ValueError, match="pseudo_proj=False"):
        GMMConv(12, 8, 2, 2)(tg, x, forms["flat"][1][:, :2])


def test_cli_default_setup_gives_the_jax_cli_logits():
    """The torch CLI with no --pseudo flag builds cora as the JAX CLI does
    (no hub block, per-edge pseudo binned in both directions): fed the flax
    model's params, the port's model gives the JAX CLI set-up's logits."""
    trainer = _load("train_gmm_torch")
    jax_cli = _load("train_gmm")
    from dgnn_tpu.data import load_citation_dataset as jax_load

    args = trainer.parser().parse_args(["--device", "cpu"])
    (graph, pseudo, mode, gather, feats, _, _, _, n_classes, _,
     _) = trainer.setup(args)
    assert mode == "binned" and gather == "float32"
    assert graph.fwd.dense is None and graph.bwd.dense is None
    # scripts/train_gmm.py:66-74
    data = jax_load(args.dataset, seed=args.seed)
    jg = jax_build_graph(data.src, data.dst, data.num_nodes)
    jp = jgmm.bin_pseudo(jg, jax_cli.edge_pseudo(jg))
    np.testing.assert_array_equal(feats, data.features)
    for tt, jt in zip(pseudo, jp):
        for x, y in zip(tt, jt):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
    jm = JaxMoNet(n_hidden=args.n_hidden, out_feats=n_classes,
                  n_layers=args.n_layers, dim=args.pseudo_dim,
                  n_kernels=args.n_kernels, dropout=args.dropout)
    features = jnp.asarray(data.features)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jg, features, jp)
    want = jax.jit(lambda p: jm.apply(p, jg, features, jp))(params)
    tm = MoNet(feats.shape[1], args.n_hidden, n_classes, args.n_layers,
               args.pseudo_dim, args.n_kernels, dropout=args.dropout,
               pseudo=mode)
    load_flax_monet(tm, params).eval()
    with torch.no_grad():
        got = tm(graph, torch.from_numpy(feats), pseudo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_cli_default_trains_cora_binned_without_a_hub_block(capsys):
    trainer = _load("train_gmm_torch")
    r = trainer.run(trainer.parser().parse_args(
        ["--dataset", "cora", "--device", "cpu", "--n-epochs", "5"]))
    assert r["pseudo_mode"] == "binned"
    assert r["graph"].fwd.dense is None and r["graph"].bwd.dense is None
    assert isinstance(r["pseudo"], tuple) and len(r["pseudo"]) == 2
    losses = r["losses"]
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert "Test Accuracy" in capsys.readouterr().out
