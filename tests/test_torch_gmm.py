"""MoNet (GMMConv, node-derived pseudo-coordinates): the port's plain
versions against the JAX package's Pallas kernels (interpret mode off-TPU),
``gmm_aggregate_node`` and the ``MoNet`` model against the JAX op and the
flax model, the trainer on the CPU, and, on a CUDA device, the port's
kernels against their plain versions.

JAX is imported inside the JAX tests only, so that the CUDA tests run on a
machine without JAX:  python -m pytest --noconftest -m cuda
tests/test_torch_gmm.py
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.models import (GMMConv, MoNet, flax_monet_state_dict,
                                   load_flax_monet)
from dgnn_tpu_torch.ops import bins, dense
from dgnn_tpu_torch.ops.gmm import (NodePseudo, gaussian_weights,
                                    gmm_aggregate_node)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ACC_TOL = dict(rtol=1e-5, atol=1e-5)    # acc / dx of one bin
STAT_TOL = dict(rtol=1e-4, atol=1e-5)   # stat rows: sums of signed terms
# A hub-block row sums up to thousands of terms, and the Pallas reference
# sums them through XLA's dot, whose order is not ours.
BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)    # the op, as tests/test_gmm_node.py
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 mode rounds the same operands on both sides, so nearly every element
# agrees to float32 summation order (BF16_TOL).  XLA's and torch's exp and
# tanh may differ by an ulp, which can move a weight across a bf16 rounding
# boundary and change that one term by 2^-8 of itself: at most BF16_FLIPS of
# the elements may leave BF16_TOL, none may leave BF16_BOUND (the rule of
# tests/test_torch_dense.py).
BF16_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_FLIPS = 1e-3
BF16_BOUND = dict(rtol=2e-2, atol=2e-2)
# Multi-tile forced block: 2 row chunks x 2 column tiles, with padded rows
# (300 of 512 real) and padded columns (2100 of 4096 real).
MULTI = dict(n=2400, r=300, c=2100)
# The op's graphs: a few hundred nodes, Zipf-skewed, bins (4, 16).
OP_N = 300
OP_BLOCK = (64, 150)


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


def _edges(rng, n, avg_degree):
    """Deduplicated random COO edges with Zipf-skewed destinations."""
    e = int(n * avg_degree)
    src = rng.integers(0, n, e)
    dst = np.minimum(rng.zipf(1.6, e) - 1, n - 1)
    uniq = np.unique(np.stack([src, dst], 1), axis=0)
    return uniq[:, 0], uniq[:, 1]


def _node_tables(rng, n, k, f, d=2, ds=1, dd=1):
    """Node tables and parameters of one GMM pass, made with numpy."""
    def a(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(feat=a(n, k, f), g=a(n, k, f), alpha=a(n, d), beta=a(n, d),
                sfeat=a(n, ds), dfeat=a(n, dd), mu=a(k, d),
                isig=(rng.random((k, d)) + 0.5).astype(np.float32))


def _bin(rng, n=120, s=16, w=8, **kw):
    """One bin's slot tables with partial, full and empty segments, and the
    node tables."""
    count = rng.integers(1, w + 1, s).astype(np.int32)
    count[[0, 5]] = 0        # empty segments
    count[1] = w             # a full one
    if w > 1:
        count[2] = w - 1     # a partly filled one
    nbr = rng.integers(0, n, (s, w)).astype(np.int32)
    nbr[np.arange(w)[None, :] >= count[:, None]] = 0  # padded slots
    return dict(_node_tables(rng, n, **kw), nbr=nbr, count=count,
                row=rng.integers(0, n, s).astype(np.int32))


def _torch(t, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in t.items()}


def _bin_fwd_args(t):
    return tuple(t[k] for k in ("feat", "alpha", "beta", "nbr", "row",
                                "count", "mu", "isig"))


def _bin_bwd_args(t):
    return tuple(t[k] for k in ("g", "beta", "dfeat", "alpha", "feat",
                                "sfeat", "nbr", "row", "count", "mu", "isig"))


def _dense_fwd_args(db, t):
    return (db, *(t[k] for k in ("beta", "alpha", "feat", "mu", "isig")))


def _dense_bwd_args(db, t):
    return (db, *(t[k] for k in ("g", "beta", "dfeat", "alpha", "feat", "mu",
                                 "isig")))


# ---------------------------------------------------------------------------
# (a): the per-bin plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_tanh", [True, False])
@pytest.mark.parametrize("k,f", [(2, 5), (3, 3)])
def test_bin_fwd_plain_matches_jax_kernel(rng, use_tanh, k, f):
    import jax.numpy as jnp

    from dgnn_tpu.ops.pallas_bins import bin_gmm_node_fwd as jax_fwd

    t = _bin(rng, k=k, f=f)
    n = t["feat"].shape[0]
    xcat = np.concatenate([t["feat"].reshape(n, -1), t["alpha"]], axis=1)
    want = jax_fwd(jnp.asarray(xcat[t["nbr"].T]),
                   jnp.asarray(t["beta"][t["row"]]), jnp.asarray(t["count"]),
                   jnp.asarray(t["mu"]), jnp.asarray(t["isig"]), K=k, D=2,
                   use_tanh=use_tanh, interpret=True)
    got = bins.bin_gmm_node_fwd_plain(*_bin_fwd_args(_torch(t)),
                                      use_tanh=use_tanh)
    # the wrapper takes the plain version for CPU tensors
    via_wrapper = bins.bin_gmm_node_fwd(*_bin_fwd_args(_torch(t)),
                                        use_tanh=use_tanh)
    np.testing.assert_allclose(got.reshape(got.shape[0], -1).numpy(),
                               np.asarray(want), **ACC_TOL)
    np.testing.assert_array_equal(via_wrapper.numpy(), got.numpy())
    assert np.all(got[[0, 5]].numpy() == 0)  # empty segments: plain zeros


@pytest.mark.parametrize("use_tanh", [True, False])
@pytest.mark.parametrize("k,f,dd,ds", [(2, 5, 1, 1), (3, 3, 2, 3)])
def test_bin_bwd_plain_matches_jax_kernel(rng, use_tanh, k, f, dd, ds):
    import jax.numpy as jnp

    from dgnn_tpu.ops.pallas_bins import bin_gmm_node_bwd as jax_bwd

    t = _bin(rng, k=k, f=f, dd=dd, ds=ds)
    n = t["feat"].shape[0]
    zcat = np.concatenate([t["g"].reshape(n, -1), t["beta"], t["dfeat"]],
                          axis=1)
    want_dx, want_st = jax_bwd(
        jnp.asarray(zcat[t["nbr"].T]), jnp.asarray(t["alpha"][t["row"]]),
        jnp.asarray(t["feat"].reshape(n, -1)[t["row"]]),
        jnp.asarray(t["sfeat"][t["row"]]), jnp.asarray(t["count"]),
        jnp.asarray(t["mu"]), jnp.asarray(t["isig"]), K=k, D=2, Dd=dd,
        use_tanh=use_tanh, interpret=True)
    dx, st = bins.bin_gmm_node_bwd(*_bin_bwd_args(_torch(t)),
                                   use_tanh=use_tanh)
    assert st.shape == (16, bins.gmm_stat_width(k, 2, dd, ds))
    np.testing.assert_allclose(dx.reshape(dx.shape[0], -1).numpy(),
                               np.asarray(want_dx), **ACC_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_st), **STAT_TOL)
    assert np.all(dx[[0, 5]].numpy() == 0) and np.all(st[[0, 5]].numpy() == 0)


def test_padded_slots_are_not_relied_on(rng):
    """Slots at or past ``count`` contribute exactly 0 whatever id they
    hold."""
    t = _bin(rng, k=2, f=4)
    junk = dict(t, nbr=t["nbr"].copy())
    pad = np.arange(8)[None, :] >= t["count"][:, None]
    junk["nbr"][pad] = 10 ** 6  # far outside the node tables
    for args, fn in ((_bin_fwd_args, bins.bin_gmm_node_fwd),
                     (_bin_bwd_args, bins.bin_gmm_node_bwd)):
        a = fn(*args(_torch(t)), use_tanh=True)
        b = fn(*args(_torch(junk)), use_tanh=True)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_gaussian_weights_match_jax(rng):
    import jax.numpy as jnp

    from dgnn_tpu.ops.gmm import gaussian_weights as jax_gw

    p = rng.normal(size=(7, 5, 2)).astype(np.float32)
    mu = rng.normal(size=(3, 2)).astype(np.float32)
    isig = (rng.random((3, 2)) + 0.5).astype(np.float32)
    got = gaussian_weights(*map(torch.from_numpy, (p, mu, isig)))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_gw(*map(jnp.asarray, (p, mu, isig)))), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# (b): the hub-block plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def multi_pair():
    """The multi-tile forced block built by both packages from one host
    graph, and node tables."""
    from dgnn_tpu.graph.structure import build_graph as jax_build_graph

    rng = np.random.default_rng(1)
    src, dst = _edges(rng, MULTI["n"], 4)
    kw = dict(dense=(MULTI["r"], MULTI["c"]))
    tg = build_graph(src, dst, MULTI["n"], **kw)
    jg = jax_build_graph(src, dst, MULTI["n"], **kw)
    assert tg.fwd.dense.mask.shape[0] == 4  # 2 row chunks x 2 column tiles
    assert tg.fwd.dense.num_rows == MULTI["r"] < tg.fwd.dense.row_ids.shape[0]
    return jg, tg, _node_tables(rng, MULTI["n"], 2, 5, dd=2)


def _jax_dt(dense_dtype):
    import jax.numpy as jnp

    return jnp.float32 if dense_dtype == "float32" else jnp.bfloat16


@pytest.mark.parametrize("use_tanh", [True, False])
@pytest.mark.parametrize("dense_dtype", ["float32", "bfloat16"])
def test_dense_fwd_plain_matches_jax_kernel(multi_pair, use_tanh, dense_dtype):
    import jax.numpy as jnp

    from dgnn_tpu.ops.pallas_dense import dense_gmm_fwd as jax_fwd

    jg, tg, t = multi_pair
    db = jg.fwd.dense
    n = t["feat"].shape[0]
    want = jax_fwd(db, jnp.asarray(t["beta"])[db.row_ids],
                   jnp.asarray(t["alpha"])[db.col_ids],
                   jnp.asarray(t["feat"].reshape(n, -1))[db.col_ids],
                   jnp.asarray(t["mu"]), jnp.asarray(t["isig"]),
                   use_tanh=use_tanh, mat_dtype=_jax_dt(dense_dtype),
                   interpret=True)
    kw = dict(use_tanh=use_tanh, dense_dtype=dense_dtype)
    args = _dense_fwd_args(tg.fwd.dense, _torch(t))
    got = dense.dense_gmm_fwd_plain(*args, **kw)
    via_wrapper = dense.dense_gmm_fwd(*args, **kw)  # CPU: the plain version
    _assert_close(got.reshape(got.shape[0], -1).numpy(), want, dense_dtype,
                  BLOCK_TOL, "acc")
    np.testing.assert_array_equal(via_wrapper.numpy(), got.numpy())
    assert np.all(got[MULTI["r"]:].numpy() == 0)  # padded rows


@pytest.mark.parametrize("use_tanh", [True, False])
@pytest.mark.parametrize("dense_dtype", ["float32", "bfloat16"])
def test_dense_bwd_plain_matches_jax_kernel(multi_pair, use_tanh, dense_dtype):
    import jax.numpy as jnp

    from dgnn_tpu.ops.pallas_dense import dense_gmm_bwd as jax_bwd

    jg, tg, t = multi_pair
    db = jg.bwd.dense
    n = t["feat"].shape[0]
    want = jax_bwd(db, jnp.asarray(t["alpha"])[db.row_ids],
                   jnp.asarray(t["beta"])[db.col_ids],
                   jnp.asarray(t["feat"].reshape(n, -1))[db.row_ids],
                   jnp.asarray(t["g"].reshape(n, -1))[db.col_ids],
                   jnp.asarray(t["dfeat"])[db.col_ids],
                   jnp.asarray(t["mu"]), jnp.asarray(t["isig"]),
                   use_tanh=use_tanh, mat_dtype=_jax_dt(dense_dtype),
                   interpret=True)
    got = dense.dense_gmm_bwd(*_dense_bwd_args(tg.bwd.dense, _torch(t)),
                              use_tanh=use_tanh, dense_dtype=dense_dtype)
    assert got[1].shape[1] == bins.gmm_stat_width(2, 2, 2)
    for name, g, w in zip(("dx", "st"), got, want):
        _assert_close(g.reshape(g.shape[0], -1).numpy(), w, dense_dtype,
                      BLOCK_TOL, name)


# ---------------------------------------------------------------------------
# (c): gmm_aggregate_node against the JAX op
# ---------------------------------------------------------------------------


def _op_problem(rng, block, k=2, f=4, d=2):
    src, dst = _edges(rng, OP_N, 5)
    kw = dict(widths=(4, 16), dense=block)
    arrs = dict(feat=rng.normal(size=(OP_N, k, f)),
                s=rng.normal(size=(OP_N, 1)), d=rng.normal(size=(OP_N, 1)),
                mu=rng.normal(size=(k, d)), isig=rng.random((k, d)) + 0.5,
                pw=rng.normal(size=(2, d)), pb=rng.normal(size=(d,)),
                ct=rng.normal(size=(OP_N, k, f)))
    return src, dst, kw, {n: a.astype(np.float32) for n, a in arrs.items()}


@pytest.mark.parametrize("block,dense_dtype,use_tanh", [
    (None, "float32", True),
    (None, "float32", False),
    (OP_BLOCK, "float32", True),
    (OP_BLOCK, "float32", False),
    (OP_BLOCK, "bfloat16", True),
    (OP_BLOCK, "bfloat16", False),
])
def test_op_forward_and_grads_match_jax(rng, block, dense_dtype, use_tanh):
    import jax
    import jax.numpy as jnp

    from dgnn_tpu.graph.structure import build_graph as jax_build_graph
    from dgnn_tpu.ops.gmm import gmm_aggregate_node as jax_op

    src, dst, kw, a = _op_problem(rng, block)
    jg = jax_build_graph(src, dst, OP_N, **kw)
    tg = build_graph(src, dst, OP_N, **kw)
    assert (tg.fwd.dense is not None) == (block is not None)
    assert (tg.bwd.dense is not None) == (block is not None)
    names = ("feat", "pw", "pb", "mu", "isig")

    @jax.jit  # one compile instead of eager interpret-mode dispatch
    def out_and_grads(g, s, d, ct, feat, pw, pb, mu, isig):
        out, vjp = jax.vjp(
            lambda feat, pw, pb, mu, isig: jax_op(
                g, feat, s, d, mu, isig, proj_weight=pw, proj_bias=pb,
                use_tanh=use_tanh, dense_dtype=dense_dtype),
            feat, pw, pb, mu, isig)
        return out, vjp(ct)

    out_j, grads_j = out_and_grads(
        jg, *(jnp.asarray(a[n]) for n in ("s", "d", "ct") + names))
    ts = {n: torch.from_numpy(a[n]).requires_grad_(True) for n in names}
    out_t = gmm_aggregate_node(
        tg, ts["feat"], torch.from_numpy(a["s"]), torch.from_numpy(a["d"]),
        ts["mu"], ts["isig"], proj_weight=ts["pw"], proj_bias=ts["pb"],
        use_tanh=use_tanh, dense_dtype=dense_dtype)
    out_t.backward(torch.from_numpy(a["ct"]))
    _assert_close(out_t.detach().numpy(), out_j, dense_dtype, FWD_TOL, "out")
    for name, gj in zip(names, grads_j):
        _assert_close(ts[name].grad.numpy(), gj, dense_dtype, GRAD_TOL, name)


def test_op_without_grad_saves_nothing_and_matches(rng):
    src, dst, kw, a = _op_problem(rng, OP_BLOCK)
    tg = build_graph(src, dst, OP_N, **kw)
    t = {n: torch.from_numpy(v) for n, v in a.items()}
    call = dict(proj_weight=t["pw"], proj_bias=t["pb"], dense_dtype="float32")
    plain = gmm_aggregate_node(tg, t["feat"], t["s"], t["d"], t["mu"],
                               t["isig"], **call)
    assert plain.grad_fn is None
    feat = t["feat"].clone().requires_grad_(True)
    with_grad = gmm_aggregate_node(tg, feat, t["s"], t["d"], t["mu"],
                                   t["isig"], **call)
    assert with_grad.grad_fn is not None
    with torch.no_grad():
        no_grad = gmm_aggregate_node(tg, feat, t["s"], t["d"], t["mu"],
                                     t["isig"], **call)
    assert no_grad.grad_fn is None
    np.testing.assert_array_equal(plain.numpy(), with_grad.detach().numpy())
    np.testing.assert_array_equal(plain.numpy(), no_grad.numpy())


def test_forced_block_matches_binned(rng):
    """The hub block changes the layout, not the function (float32)."""
    src, dst, kw, a = _op_problem(rng, OP_BLOCK)
    res = []
    for block in (OP_BLOCK, None):
        g = build_graph(src, dst, OP_N, widths=(4, 16), dense=block)
        ts = {n: torch.from_numpy(a[n]).requires_grad_(True)
              for n in ("feat", "pw", "pb", "mu", "isig")}
        out = gmm_aggregate_node(
            g, ts["feat"], torch.from_numpy(a["s"]), torch.from_numpy(a["d"]),
            ts["mu"], ts["isig"], proj_weight=ts["pw"], proj_bias=ts["pb"],
            dense_dtype="float32")
        torch.sin(out).sum().backward()
        res.append([out.detach()] + [t.grad for t in ts.values()])
    torch.testing.assert_close(res[0][0], res[1][0], **FWD_TOL)
    for x, y in zip(res[0][1:], res[1][1:]):
        torch.testing.assert_close(x, y, **GRAD_TOL)


def test_op_refusals(rng):
    src, dst, kw, a = _op_problem(rng, OP_BLOCK)
    g = build_graph(src, dst, OP_N, **kw)
    t = {n: torch.from_numpy(v) for n, v in a.items()}
    args = (g, t["feat"], t["s"], t["d"], t["mu"], t["isig"])
    call = dict(proj_weight=t["pw"], proj_bias=t["pb"])
    with pytest.raises(NotImplementedError, match="gather_dtype"):
        gmm_aggregate_node(*args, **call, gather_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dense_dtype"):
        gmm_aggregate_node(*args, **call, dense_dtype="fp16")
    with pytest.raises(ValueError, match="proj_weight"):
        gmm_aggregate_node(*args, proj_weight=t["pw"][:1], proj_bias=t["pb"])
    with pytest.raises(TypeError, match="float32"):
        gmm_aggregate_node(g, t["feat"].double(), *args[2:], **call)
    with pytest.raises(ValueError, match="devices"):
        bins.bin_gmm_node_fwd(*_bin_fwd_args(dict(
            _torch(_bin(rng, k=2, f=4)), alpha=t["mu"].to("meta"))),
            use_tanh=True)
    with pytest.raises(ValueError, match="devices"):
        dense.dense_gmm_fwd(g.fwd.dense, t["s"].to("meta"), t["d"],
                            t["feat"], t["mu"], t["isig"], use_tanh=True)


# ---------------------------------------------------------------------------
# (d): the model against the flax model on converted weights
# ---------------------------------------------------------------------------


def _model_problem(rng, block, n=200, in_feats=12):
    from dgnn_tpu.graph.structure import build_graph as jax_build_graph

    src, dst = _edges(rng, n, 4)
    feat = rng.normal(size=(n, in_feats)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    jg = jax_build_graph(src, dst, n, dense=block)
    tg = build_graph(src, dst, n, dense=block)
    assert (tg.fwd.dense is not None) == (block is not None)
    rsq = (1.0 / np.sqrt(np.maximum(np.diff(tg.row_ptr.numpy()), 1))
           ).astype(np.float32)[:, None]
    return jg, tg, feat, labels, rsq


@pytest.mark.parametrize("block", [None, (64, 150)])
def test_converted_monet_logits_and_grads_equal(rng, block):
    """Flax MoNet (2 GMMConv layers) -> load_flax_monet: equal logits in
    eval mode and equal parameter gradients with dropout 0; on the hub graph
    at the model's default dense_dtype (bfloat16)."""
    import jax
    import jax.numpy as jnp
    import optax

    from dgnn_tpu.models import MoNet as JaxMoNet
    from dgnn_tpu.ops.gmm import NodePseudo as JaxNodePseudo

    jg, tg, feat, labels, rsq = _model_problem(rng, block)
    jm = JaxMoNet(n_hidden=8, out_feats=3, n_layers=1, dim=2, n_kernels=2,
                  dropout=0.0)
    jp = JaxNodePseudo(src=jnp.asarray(rsq), dst=jnp.asarray(rsq))
    params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(feat), jp)
    tm = MoNet(feat.shape[1], 8, 3, 1, 2, 2, dropout=0.0,
               generator=torch.Generator().manual_seed(0))
    load_flax_monet(tm, params)
    tp = NodePseudo(src=torch.from_numpy(rsq), dst=torch.from_numpy(rsq))
    dt = "float32" if block is None else "bfloat16"

    def loss_fn(p):
        logits = jm.apply(p, jg, jnp.asarray(feat), jp, training=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    tm.eval()
    with torch.no_grad():
        got = tm(tg, torch.from_numpy(feat), tp)
    _assert_close(got.numpy(), want, dt, dict(rtol=1e-5, atol=1e-5), "logits")
    tm.train()
    logits = tm(tg, torch.from_numpy(feat), tp)
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels).long()).backward()
    want_grads = flax_monet_state_dict(grads)
    assert set(want_grads) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        _assert_close(p.grad.numpy(), want_grads[name].numpy(), dt, GRAD_TOL,
                      name)


def test_converted_gmmconv_with_residual_equal(rng):
    import jax
    import jax.numpy as jnp

    from dgnn_tpu.models.monet import GMMConv as JaxGMMConv
    from dgnn_tpu.ops.gmm import NodePseudo as JaxNodePseudo

    jg, tg, feat, _, rsq = _model_problem(rng, None)
    jl = JaxGMMConv(out_feats=5, dim=2, n_kernels=3, residual=True)
    jp = JaxNodePseudo(src=jnp.asarray(rsq), dst=jnp.asarray(rsq))
    params = jl.init(jax.random.PRNGKey(2), jg, jnp.asarray(feat), jp)
    assert "res_fc" in params["params"]
    want = jl.apply(params, jg, jnp.asarray(feat), jp)
    tl = GMMConv(feat.shape[1], 5, 2, 3, residual=True,
                 generator=torch.Generator().manual_seed(0))
    sd = flax_monet_state_dict({"gmm_0": params["params"]})
    tl.load_state_dict({k.removeprefix("convs.gmm_0."): v
                        for k, v in sd.items()}, strict=True)
    got = tl(tg, torch.from_numpy(feat), NodePseudo(
        src=torch.from_numpy(rsq), dst=torch.from_numpy(rsq)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # same width: the identity residual, no res_fc
    same = GMMConv(5, 5, 2, 3, residual=True,
                   generator=torch.Generator().manual_seed(0))
    assert same.res_fc is None and GMMConv(4, 5, 2, 3).res_fc is None


def test_monet_init_follows_flax():
    tm = MoNet(500, 64, 3, 1, 2, 3, generator=torch.Generator().manual_seed(0))
    conv = tm.convs["gmm_0"]
    assert list(tm.convs) == ["gmm_0", "gmm_1"]
    # variance_scaling(2, fan_avg, normal): std = sqrt(2 / ((in + out) / 2))
    want = np.sqrt(2.0 / ((500 + 192) / 2))
    assert abs(float(conv.fc.weight.detach().std()) / want - 1) < 0.1
    big = GMMConv(8, 8, 64, 64, pseudo_in=2,
                  generator=torch.Generator().manual_seed(0))
    assert abs(float(big.mu.detach().std()) / 0.1 - 1) < 0.1
    assert torch.all(big.inv_sigma == 1) and torch.all(big.pseudo_b == 0)
    assert torch.all(big.bias == 0)
    # lecun_normal: variance 1 / fan_in, truncated at two standard deviations
    pw = big.pseudo_w.detach()
    assert abs(float(pw.std()) / np.sqrt(1 / 2) - 1) < 0.2
    assert float(pw.abs().max()) <= 2 * np.sqrt(1 / 2) / 0.87962566 + 1e-6
    a = MoNet(20, 8, 3, 1, 2, 3, generator=torch.Generator().manual_seed(5))
    b = MoNet(20, 8, 3, 1, 2, 3, generator=torch.Generator().manual_seed(5))
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)  # the generator decides every draw


def test_model_refuses_other_pseudo_modes(rng):
    _, tg, feat, _, rsq = _model_problem(rng, None)
    tm = MoNet(feat.shape[1], 8, 3, 1, 2, 2)
    x = torch.from_numpy(feat)
    flat = torch.zeros((tg.num_edges, 2))
    with pytest.raises(NotImplementedError, match="A6"):
        tm(tg, x, flat)
    with pytest.raises(NotImplementedError, match="A6"):
        tm.convs["gmm_0"](tg, x, (flat,))
    pseudo = NodePseudo(src=torch.from_numpy(rsq), dst=torch.from_numpy(rsq))
    with pytest.raises(ValueError, match="Generator"):
        tm.train()(tg, x, pseudo)  # dropout 0.5 in training needs one


# ---------------------------------------------------------------------------
# (e): the trainer on the CPU
# ---------------------------------------------------------------------------


def _trainer():
    spec = importlib.util.spec_from_file_location(
        "train_gmm_torch", ROOT / "scripts" / "train_gmm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trainer_on_cpu_cora(capsys, tmp_path):
    """Cora keeps a hub block in both directions, so the CPU run goes
    through all four plain versions."""
    trainer = _trainer()
    out = tmp_path / "r.csv"
    r = trainer.run(trainer.parser().parse_args(
        ["--device", "cpu", "--n-epochs", "6", "--output", str(out)]))
    assert r["graph"].fwd.dense is not None
    assert r["graph"].bwd.dense is not None
    assert r["graph"].row_ptr.numel() == 0  # slimmed after the degrees
    assert r["pseudo"].src.shape == (r["graph"].num_nodes, 1)
    assert float(r["pseudo"].src.max()) <= 1.0
    losses = r["losses"]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert "Test Accuracy" in capsys.readouterr().out
    row = [ln for ln in out.read_text().splitlines() if ln[0] != "#"]
    assert len(row) == 1 and row[0].startswith(
        "train_GMM_dgnn_tpu_torch,cora pseudo_dim=2 n_kernels=3 hidden_dim=16,")


def test_trainer_cli_refusals():
    trainer = _trainer()
    p = trainer.parser()
    assert p.parse_args([]).device == "cuda"
    assert p.parse_args([]).pseudo == "node"
    with pytest.raises(NotImplementedError, match="binned"):
        trainer.run(p.parse_args(["--device", "cpu", "--pseudo", "binned"]))
    with pytest.raises(ValueError, match="warmup"):
        trainer.run(p.parse_args(["--device", "cpu", "--n-epochs", "2"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer.run(p.parse_args(["--n-epochs", "5"]))


def test_trainers_agree_for_four_adam_steps(rng):
    """Adam + coupled weight decay on both sides, from the same weights,
    with the CLI's loss and the trainer's step."""
    import jax
    import jax.numpy as jnp
    import optax

    from dgnn_tpu.models import MoNet as JaxMoNet
    from dgnn_tpu.ops.gmm import NodePseudo as JaxNodePseudo

    jg, tg, feat, labels, rsq = _model_problem(rng, None, n=80)
    train_mask = rng.random(80) < 0.5
    jm = JaxMoNet(n_hidden=8, out_feats=3, n_layers=1, dim=2, n_kernels=2,
                  dropout=0.0)
    jp = JaxNodePseudo(src=jnp.asarray(rsq), dst=jnp.asarray(rsq))
    params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(feat), jp)
    tm = load_flax_monet(MoNet(feat.shape[1], 8, 3, 1, 2, 2, dropout=0.0),
                         params)
    tx = optax.chain(optax.add_decayed_weights(5e-4), optax.adam(1e-2))
    opt_state = tx.init(params)
    mask_j = jnp.asarray(train_mask)

    @jax.jit
    def jax_step(params, opt_state):
        def loss_fn(p):  # scripts/train_gmm.py's loss
            logits = jm.apply(p, jg, jnp.asarray(feat), jp, training=True)
            losses = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(labels))
            return jnp.sum(losses * mask_j) / jnp.sum(mask_j)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    trainer = _trainer()
    opt = trainer.make_optimizer(tm, 1e-2, 5e-4)
    tp = NodePseudo(src=torch.from_numpy(rsq), dst=torch.from_numpy(rsq))
    for step in range(4):
        params, opt_state, loss_j = jax_step(params, opt_state)
        loss_t = trainer.train_step(
            tm, opt, tg, torch.from_numpy(feat), tp,
            torch.from_numpy(labels).long(), torch.from_numpy(train_mask),
            None)
        rtol = 1e-4 if step == 0 else 1e-3
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=rtol,
                                   err_msg=f"step {step}")


def test_node_pseudo_matches_jax_bench_protocol(rng):
    """rsqrt of the clamped in-degree, taken before slim() drops the CSR."""
    trainer = _trainer()
    src, dst = _edges(rng, 60, 3)
    g = build_graph(src, dst, 60, self_loops=False)  # zero in-degrees occur
    deg = np.diff(g.row_ptr.numpy())
    assert (deg == 0).any()
    ps = trainer.node_pseudo(g)
    want = 1.0 / np.sqrt(np.maximum(deg, 1).astype(np.float32))
    np.testing.assert_allclose(ps.src[:, 0].numpy(), want, rtol=1e-6)
    assert ps.src.shape == (60, 1) and ps.dst is ps.src


# ---------------------------------------------------------------------------
# (f): the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scaled_g(t):
    """Output gradients at 1/16 scale (see chip_smoke.py G_SCALE)."""
    return dict(t, g=t["g"] / 16)


@pytest.mark.cuda
@pytest.mark.parametrize("use_tanh", [True, False])
@pytest.mark.parametrize("w,k,f,d,dd,ds", [
    (4, 3, 64, 2, 1, 1),    # K*F = 192: the hidden layer
    (12, 3, 3, 2, 1, 1),    # K*F = 9: pubmed's output layer
    (8, 3, 7, 2, 1, 1),     # K*F = 21: cora's output layer
    (1, 2, 5, 2, 1, 1),     # a bin of width 1
    (96, 2, 5, 1, 4, 3),    # wider than 64 slots; D, Dd, Ds other than the model's
    (8, 8, 128, 2, 1, 4),   # K*F = 1024, and the backward's 3D + D*Dd = 8
])
def test_cuda_bin_kernels_match_plain(rng, cuda_device, use_tanh, w, k, f, d,
                                      dd, ds):
    t = _scaled_g(_torch(_bin(rng, n=500, s=40, w=w, k=k, f=f, d=d, dd=dd,
                              ds=ds), cuda_device))
    before = dict(bins.LAUNCHES)
    got = bins.bin_gmm_node_fwd(*_bin_fwd_args(t), use_tanh=use_tanh)
    want = bins.bin_gmm_node_fwd_plain(*_bin_fwd_args(t), use_tanh=use_tanh)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ACC_TOL)
    got = bins.bin_gmm_node_bwd(*_bin_bwd_args(t), use_tanh=use_tanh)
    want = bins.bin_gmm_node_bwd_plain(*_bin_bwd_args(t), use_tanh=use_tanh)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, **STAT_TOL)
    assert bins.LAUNCHES["bin_gmm_node_fwd"] == before["bin_gmm_node_fwd"] + 1
    assert bins.LAUNCHES["bin_gmm_node_bwd"] == before["bin_gmm_node_bwd"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dense_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_tanh", [True, False])
@pytest.mark.parametrize("block,k,f,dd", [
    ((MULTI["r"], MULTI["c"]), 3, 64, 1),   # 2 x 2 tiles, K*F = 192
    ((MULTI["r"], MULTI["c"]), 3, 7, 1),    # K*F = 21
    ((200, 1500), 3, 3, 2),                 # a row chunk of one tile, K*F = 9
    ((200, 1500), 8, 40, 4),                # K*F = 320: 32 columns a lane
])
def test_cuda_dense_kernels_match_plain(rng, cuda_device, dense_dtype,
                                        use_tanh, block, k, f, dd):
    src, dst = _edges(rng, MULTI["n"], 4)
    g = build_graph(src, dst, MULTI["n"], dense=block).to(cuda_device)
    assert g.fwd.dense.mask.shape[0] == (4 if block[1] > 2048 else 1)
    t = _scaled_g(_torch(_node_tables(rng, MULTI["n"], k, f, dd=dd),
                         cuda_device))
    # The hub row of this graph sums about 2000 unit-sized terms, in an
    # order that the plain version's index_add_ does not fix from run to
    # run: float32's rounding floor of such a sum is above BLOCK_TOL's atol,
    # which suits the at most 128 terms of a bin segment.  The absolute
    # tolerance grows with the widest row, in units of 128 terms.
    widest = max(np.bincount(dst).max(), np.bincount(src).max())
    tol = dict(BLOCK_TOL, atol=BLOCK_TOL["atol"] * max(1.0, widest / 128))
    kw = dict(use_tanh=use_tanh, dense_dtype=dense_dtype)
    before = dict(dense.LAUNCHES)
    got = dense.dense_gmm_fwd(*_dense_fwd_args(g.fwd.dense, t), **kw)
    want = dense.dense_gmm_fwd_plain(*_dense_fwd_args(g.fwd.dense, t), **kw)
    torch.cuda.synchronize()
    _assert_close(got.cpu(), want.cpu(), dense_dtype, tol, "acc")
    got = dense.dense_gmm_bwd(*_dense_bwd_args(g.bwd.dense, t), **kw)
    want = dense.dense_gmm_bwd_plain(*_dense_bwd_args(g.bwd.dense, t), **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("dx", "st"), got, want):
        _assert_close(x.cpu(), y.cpu(), dense_dtype, tol, name)
    assert dense.LAUNCHES["dense_gmm_fwd"] == before["dense_gmm_fwd"] + 1
    assert dense.LAUNCHES["dense_gmm_bwd"] == before["dense_gmm_bwd"] + 1


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(rng, cuda_device):
    t = _torch(_bin(rng, k=2, f=4), cuda_device)
    with pytest.raises(TypeError, match="float32"):
        bins.bin_gmm_node_fwd(*_bin_fwd_args(dict(
            t, feat=t["feat"].to(torch.bfloat16))), use_tanh=True)
    nine = _torch(_bin(rng, k=9, f=4), cuda_device)
    with pytest.raises(ValueError, match="kernels"):
        bins.bin_gmm_node_fwd(*_bin_fwd_args(nine), use_tanh=True)
    wide = _torch(_bin(rng, k=2, f=600), cuda_device)
    with pytest.raises(ValueError, match="feature columns"):
        bins.bin_gmm_node_bwd(*_bin_bwd_args(wide), use_tanh=True)
    five = _torch(_bin(rng, k=2, f=4, dd=5), cuda_device)
    with pytest.raises(ValueError, match="Dd=5"):
        bins.bin_gmm_node_bwd(*_bin_bwd_args(five), use_tanh=True)
    many = _torch(_bin(rng, k=2, f=4, d=3, dd=2), cuda_device)
    with pytest.raises(ValueError, match="3D \\+ D\\*Dd"):
        bins.bin_gmm_node_bwd(*_bin_bwd_args(many), use_tanh=True)
