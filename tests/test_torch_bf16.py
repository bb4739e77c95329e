"""bf16 feature gathers (``gather_dtype``): ``gat_aggregate``,
``gmm_aggregate_node``, ``GAT`` and ``MoNet`` against the JAX package's
``gather_dtype=bfloat16`` (its Pallas kernels in interpret mode), forward
and every gradient, on graphs with and without a hub block; and, on a CUDA
device, the bf16 instances of the four bin kernels against their plain
versions.

Tolerance: both sides round the same operands to bf16 at the same places,
so nearly every element agrees to float32 summation order (TIGHT).  One
exception: the GAT op's backward reads its destination columns (ar, M,
Linv, ws) as float32 tables, where the JAX op narrows them with the
gathered rows, so ``gat_aggregate``'s d ac and d feat are held to the JAX
op's float32 gradients instead: within BOUND, and no farther from them
than the JAX op's own bf16 gradients are.  A
float32 value that differs by an ulp between the two sides can round to
the neighbouring bf16 value (2^-8 of itself) where it is rounded again (the
gathered ws, Linv and M columns; d_feat): at most FLIPS (0.1 %) of the
elements may leave TIGHT, none may leave BOUND (2e-2).  In a two-layer
model one such flip in the second layer's gathered rows moves every row
that row feeds (a hub row of the Zipf graph sums hundreds), so the models'
logits and gradients are held to BOUND, and the flip share to each layer's
own output: the first layer's in the port's own pass, the logits in a pass
whose first layer hands on the flax model's first-layer output, so that
only the layers after it (their own bf16 rounding included) tell the two
apart.

JAX is imported inside the JAX tests only, so that the CUDA tests run on a
machine without JAX:  python -m pytest --noconftest -m cuda
tests/test_torch_bf16.py
"""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import numpy as np
import pytest
import torch

from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.ops import bins
from dgnn_tpu_torch.ops.gat import gat_aggregate
from dgnn_tpu_torch.ops.gmm import gmm_aggregate_node

TIGHT = dict(rtol=1e-4, atol=1e-5)
BOUND = dict(rtol=2e-2, atol=2e-2)
FLIPS = 1e-3
N = 300
BLOCK = (64, 150)  # a forced hub block of the Zipf graph, both directions
SLOPE = 0.2
SEED = 2 ** 31 + 12345


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _close(got, want, what=""):
    """Every element within BOUND; at most FLIPS of them outside TIGHT."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, err_msg=what, **BOUND)
    off = ~np.isclose(got, want, **TIGHT)
    assert off.mean() <= FLIPS, (what, int(off.sum()), off.size)


def _edges(rng, n=N, avg_degree=5):
    e = int(n * avg_degree)
    src = rng.integers(0, n, e)
    dst = np.minimum(rng.zipf(1.6, e) - 1, n - 1)
    uniq = np.unique(np.stack([src, dst], 1), axis=0)
    return uniq[:, 0], uniq[:, 1]


def _graphs(rng, block):
    from dgnn_tpu.graph.structure import build_graph as jax_build_graph

    src, dst = _edges(rng)
    kw = dict(widths=(4, 16), dense=block, edge_tables=False)
    tg = build_graph(src, dst, N, **kw)
    assert (tg.fwd.dense is not None) == (block is not None)
    assert (tg.bwd.dense is not None) == (block is not None)
    return jax_build_graph(src, dst, N, **kw), tg


@pytest.mark.parametrize("block,p,dense_dtype", [
    (None, 0.0, "bfloat16"), (None, 0.3, "bfloat16"),
    (BLOCK, 0.0, "float32"), (BLOCK, 0.3, "bfloat16")])
def test_gat_aggregate_bf16_matches_jax(rng, block, p, dense_dtype):
    import jax
    import jax.numpy as jnp

    from dgnn_tpu.ops.gat import gat_aggregate as jax_gat

    jg, tg = _graphs(rng, block)
    h, f = 4, 8
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((N, h), (N, h), (N, h, f), (N, h, f))]
    key = jax.random.PRNGKey(7)
    seed = int(jax.random.bits(key, dtype=jnp.uint32))

    def out_and_grads(gather_dtype):
        @jax.jit
        def run(g, ar, ac, feat, ct):
            out, vjp = jax.vjp(
                lambda *a: jax_gat(g, *a, attn_drop=p, key=key,
                                   training=True, gather_dtype=gather_dtype,
                                   dense_dtype=dense_dtype), ar, ac, feat)
            return out, vjp(ct)
        return run(jg, *(jnp.asarray(a) for a in arrs))

    out_j, grads_j = out_and_grads(jnp.bfloat16)
    _, grads_32 = out_and_grads(None)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs[:3]]
    out_t = gat_aggregate(tg, *ts, attn_drop=p, seed=seed, training=True,
                          gather_dtype=torch.bfloat16,
                          dense_dtype=dense_dtype)
    assert out_t.dtype == torch.float32
    out_t.backward(torch.from_numpy(arrs[3]))
    _close(out_t.detach().numpy(), out_j, "out")
    assert all(t.grad.dtype == torch.float32 for t in ts)
    _close(ts[0].grad.numpy(), grads_j[0], "dar")
    for name, t, gj, g32 in zip(("ac", "feat"), ts[1:], grads_j[1:],
                                grads_32[1:]):
        got, g32 = t.grad.numpy(), np.asarray(g32)
        np.testing.assert_allclose(got, g32, err_msg="d" + name, **BOUND)
        assert (np.linalg.norm(got - g32)
                <= np.linalg.norm(np.asarray(gj) - g32)), "d" + name
    # d_feat is returned rounded to bf16, as the JAX op returns it
    d_feat = ts[2].grad
    assert torch.equal(d_feat, d_feat.to(torch.bfloat16).float())


@pytest.mark.parametrize("block,dense_dtype", [
    (None, "bfloat16"), (BLOCK, "float32"), (BLOCK, "bfloat16")])
def test_gmm_aggregate_node_bf16_matches_jax(rng, block, dense_dtype):
    import jax
    import jax.numpy as jnp

    from dgnn_tpu.ops.gmm import gmm_aggregate_node as jax_op

    jg, tg = _graphs(rng, block)
    k, f, d = 2, 8, 2
    a = dict(feat=rng.normal(size=(N, k, f)), s=rng.normal(size=(N, 1)),
             d=rng.normal(size=(N, 1)), mu=rng.normal(size=(k, d)),
             isig=rng.random((k, d)) + 0.5, pw=rng.normal(size=(2, d)),
             pb=rng.normal(size=(d,)), ct=rng.normal(size=(N, k, f)))
    a = {n: v.astype(np.float32) for n, v in a.items()}
    names = ("feat", "pw", "pb", "mu", "isig")

    @jax.jit
    def out_and_grads(g, s, d_, ct, *xs):
        out, vjp = jax.vjp(
            lambda feat, pw, pb, mu, isig: jax_op(
                g, feat, s, d_, mu, isig, proj_weight=pw, proj_bias=pb,
                dense_dtype=dense_dtype, gather_dtype=jnp.bfloat16), *xs)
        return out, vjp(ct)

    out_j, grads_j = out_and_grads(
        jg, *(jnp.asarray(a[n]) for n in ("s", "d", "ct") + names))
    ts = {n: torch.from_numpy(a[n]).requires_grad_(True) for n in names}
    out_t = gmm_aggregate_node(
        tg, ts["feat"], torch.from_numpy(a["s"]), torch.from_numpy(a["d"]),
        ts["mu"], ts["isig"], proj_weight=ts["pw"], proj_bias=ts["pb"],
        dense_dtype=dense_dtype, gather_dtype="bfloat16")
    assert out_t.dtype == torch.float32
    out_t.backward(torch.from_numpy(a["ct"]))
    _close(out_t.detach().numpy(), out_j, "out")
    for name, gj in zip(names, grads_j):
        _close(ts[name].grad.numpy(), gj, "d" + name)
    d_feat = ts["feat"].grad
    assert torch.equal(d_feat, d_feat.to(torch.bfloat16).float())


def test_bf16_differs_from_float32_and_refuses_other_types(rng):
    """The knob is live (the rows are rounded), and only None, float32 and
    bfloat16 are taken."""
    _, tg = _graphs(rng, None)
    ar, ac = (torch.from_numpy(rng.normal(size=(N, 2)).astype(np.float32))
              for _ in range(2))
    feat = torch.from_numpy(rng.normal(size=(N, 2, 3)).astype(np.float32))
    f32 = gat_aggregate(tg, ar, ac, feat)
    assert torch.equal(f32, gat_aggregate(tg, ar, ac, feat,
                                          gather_dtype=torch.float32))
    bf = gat_aggregate(tg, ar, ac, feat, gather_dtype="bfloat16")
    assert not torch.equal(f32, bf)
    torch.testing.assert_close(bf, f32, **BOUND)
    with pytest.raises(ValueError, match="gather_dtype"):
        gat_aggregate(tg, ar, ac, feat, gather_dtype=torch.float16)


def _model_close(tm, first, loss_fn, params, args, labels, to_state):
    """The port's model ``tm`` against the flax model's ``loss_fn`` (which
    returns (loss, (logits, intermediates))): the first layer's output
    (module ``first``) by _close; the logits by _close when the port's
    first layer hands on the flax model's first-layer output, which holds
    the output layer's own rounding (a layer left in float32 fails it); the
    logits and every parameter gradient of the port's own pass within
    BOUND."""
    import jax

    (_, (want, inter)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    first_want = np.array(inter[first]["__call__"][0])
    tm.train()
    hook = tm.convs[first].register_forward_hook(
        lambda mod, inp, out: torch.from_numpy(first_want))
    with torch.no_grad():
        fed = tm(*args)
    hook.remove()
    _close(fed.numpy(), want, "logits after the flax first layer")
    seen = []
    hook = tm.convs[first].register_forward_hook(
        lambda mod, inp, out: seen.append(out.detach()))
    logits = tm(*args)
    hook.remove()
    _close(seen[0].numpy(), first_want, first)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               err_msg="logits", **BOUND)
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels).long()).backward()
    want_grads = to_state(grads)
    assert set(want_grads) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **BOUND)


def test_gat_model_bf16_matches_flax(rng):
    import jax
    import jax.numpy as jnp
    import optax

    from dgnn_tpu.models import GAT as JaxGAT
    from dgnn_tpu_torch.models import GAT, flax_gat_state_dict, load_flax_gat

    jg, tg = _graphs(rng, BLOCK)
    feat = rng.normal(size=(N, 16)).astype(np.float32)
    labels = rng.integers(0, 3, N)
    jm = JaxGAT(num_layers=1, n_hidden=8, n_classes=3, heads=(4, 1),
                gather_dtype="bfloat16")
    params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(feat))
    tm = GAT(16, 1, 8, 3, (4, 1), gather_dtype="bfloat16")
    load_flax_gat(tm, params)

    def loss_fn(p):
        logits, state = jm.apply(p, jg, jnp.asarray(feat), training=True,
                                 capture_intermediates=True,
                                 mutable=["intermediates"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()
        return loss, (logits, state["intermediates"])

    _model_close(tm, "gat_0", loss_fn, params, (tg, torch.from_numpy(feat)),
                 labels, flax_gat_state_dict)


def test_monet_model_bf16_matches_flax(rng):
    import jax
    import jax.numpy as jnp
    import optax

    from dgnn_tpu.models import MoNet as JaxMoNet
    from dgnn_tpu.ops.gmm import NodePseudo as JaxNodePseudo
    from dgnn_tpu_torch.models import (MoNet, flax_monet_state_dict,
                                       load_flax_monet)
    from dgnn_tpu_torch.ops.gmm import NodePseudo

    jg, tg = _graphs(rng, BLOCK)
    feat = rng.normal(size=(N, 12)).astype(np.float32)
    labels = rng.integers(0, 3, N)
    rsq = (1.0 / np.sqrt(np.maximum(np.diff(tg.row_ptr.numpy()), 1))
           ).astype(np.float32)[:, None]
    jp = JaxNodePseudo(src=jnp.asarray(rsq), dst=jnp.asarray(rsq))
    jm = JaxMoNet(n_hidden=8, out_feats=3, n_layers=1, dim=2, n_kernels=2,
                  dropout=0.0, gather_dtype="bfloat16")
    params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(feat), jp)
    tm = MoNet(12, 8, 3, 1, 2, 2, dropout=0.0, gather_dtype="bfloat16")
    load_flax_monet(tm, params)
    tp = NodePseudo(src=torch.from_numpy(rsq), dst=torch.from_numpy(rsq))

    def loss_fn(p):
        logits, state = jm.apply(p, jg, jnp.asarray(feat), jp, training=True,
                                 capture_intermediates=True,
                                 mutable=["intermediates"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()
        return loss, (logits, state["intermediates"])

    _model_close(tm, "gmm_0", loss_fn, params,
                 (tg, torch.from_numpy(feat), tp), labels,
                 flax_monet_state_dict)


def test_plain_bin_versions_widen_bf16_rows(rng):
    """A bin wrapper on the CPU given bf16 rows computes what it computes on
    the same values held as float32."""
    _, tg = _graphs(rng, None)
    segs = tg.fwd.segs()
    h, f = 2, 4
    feat = torch.from_numpy(rng.normal(size=(N, h, f)).astype(np.float32))
    ac, ar = (torch.from_numpy(rng.normal(size=(N, h)).astype(np.float32))
              for _ in range(2))
    kw = dict(slope=SLOPE, with_pos=True, p=0.3, seed=SEED)
    bf = feat.to(torch.bfloat16)
    for x, y in zip(bins.bin_gat_fwd_list(bf, ac, ar, segs, **kw),
                    bins.bin_gat_fwd_list(bf.float(), ac, ar, segs, **kw)):
        assert x.dtype == torch.float32
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# On a CUDA device: the bf16 instances against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _cuda_graph(rng, dev):
    src, dst = _edges(rng, 2000, 6)
    return build_graph(src, dst, 2000, widths=(8, 128),
                       edge_tables=False).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("h,f", [(4, 64), (1, 3), (2, 5)])
def test_cuda_bf16_gat_list_kernels_match_plain(rng, cuda_device, h, f):
    g = _cuda_graph(rng, cuda_device)
    n = g.num_nodes

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(cuda_device)

    feat = t(n, h, f).to(torch.bfloat16)
    ac, ar, M = t(n, h), t(n, h), t(n, h) + 2.0
    Linv = torch.rand((n, h), device=cuda_device) + 0.1
    gr, ws = t(n, h, f, scale=1 / 16).to(torch.bfloat16), t(n, h)
    kw = dict(slope=SLOPE, with_pos=True, p=0.3, seed=SEED)
    atol = 8 * max(g.fwd.widths) * 2.0 ** -23
    for x, y in zip(bins.bin_gat_fwd_list(feat, ac, ar, g.fwd.segs(), **kw),
                    bins.bin_gat_fwd_list_plain(feat, ac, ar, g.fwd.segs(),
                                                **kw)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=max(1e-5, atol))
    args = (gr, ar, M, Linv, ws, ac, feat, g.bwd.segs())
    kw = dict(slope=SLOPE, p=0.3, seed=SEED)
    for x, y in zip(bins.bin_gat_bwd_list(*args, **kw),
                    bins.bin_gat_bwd_list_plain(*args, **kw)):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=max(1e-5, atol))


@pytest.mark.cuda
@pytest.mark.parametrize("k,f", [(3, 64), (3, 3), (2, 5)])
def test_cuda_bf16_gmm_list_kernels_match_plain(rng, cuda_device, k, f):
    g = _cuda_graph(rng, cuda_device)
    n = g.num_nodes

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(cuda_device)

    feat = t(n, k, f).to(torch.bfloat16)
    gr = t(n, k, f, scale=1 / 16).to(torch.bfloat16)
    alpha, beta, sfeat, dfeat = t(n, 2), t(n, 2), t(n, 1), t(n, 1)
    mu = t(k, 2)
    isig = torch.rand((k, 2), device=cuda_device) + 0.5
    atol = 8 * max(g.fwd.widths) * 2.0 ** -23
    args = (feat, alpha, beta, g.fwd.segs(), mu, isig)
    torch.testing.assert_close(
        bins.bin_gmm_node_fwd_list(*args, use_tanh=True),
        bins.bin_gmm_node_fwd_list_plain(*args, use_tanh=True),
        rtol=1e-5, atol=max(1e-5, atol))
    args = (gr, beta, dfeat, alpha, feat, sfeat, g.bwd.segs(), mu, isig)
    for x, y in zip(bins.bin_gmm_node_bwd_list(*args, use_tanh=True),
                    bins.bin_gmm_node_bwd_list_plain(*args, use_tanh=True)):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=max(1e-5, atol))
