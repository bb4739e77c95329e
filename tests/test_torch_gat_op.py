"""gat_aggregate: the port's autograd Function against jax.vjp of the JAX
op, on the same host-built graphs (tests/test_torch_graph.py holds the two
packages' layouts equal), with and without attention dropout."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgnn_tpu.graph.structure import build_graph as jax_build_graph
from dgnn_tpu.ops.gat import gat_aggregate as jax_gat
from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.ops import bins
from dgnn_tpu_torch.ops.gat import gat_aggregate
from tests.conftest import random_graph

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # as tests/test_gat_op.py

# name: (num_nodes, avg_degree, power_law, widths, self_loops)
GRAPHS = {
    "uniform": (200, 4, False, None, True),
    # a hub row of in-degree > 128: a bin wider than 64, split into segments
    "power_law": (300, 5, True, (8, 128), True),
    # no self loops: rows with zero in-degree
    "zero_in_degree": (150, 2, False, (2, 8), False),
}


def _setup(rng, name, h, f):
    n, deg, power_law, widths, self_loops = GRAPHS[name]
    src, dst = random_graph(rng, n, deg, power_law=power_law)
    jg = jax_build_graph(src, dst, n, widths=widths, self_loops=self_loops)
    tg = build_graph(src, dst, n, widths=widths, self_loops=self_loops)
    if name == "power_law":
        assert max(tg.fwd.widths) > 64
    if name == "zero_in_degree":
        assert (np.diff(tg.row_ptr.numpy()) == 0).any()
    arrs = [rng.normal(size=(n, h)).astype(np.float32),
            rng.normal(size=(n, h)).astype(np.float32),
            rng.normal(size=(n, h, f)).astype(np.float32)]
    return jg, tg, arrs


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("p", [0.0, 0.3])
def test_forward_and_grads_match_jax(rng, name, p):
    h, f = 3, 4
    jg, tg, arrs = _setup(rng, name, h, f)
    key = jax.random.PRNGKey(7)
    seed = int(jax.random.bits(key, dtype=jnp.uint32))
    ct = rng.normal(size=arrs[2].shape).astype(np.float32)

    @jax.jit  # one compile instead of eager interpret-mode dispatch
    def out_and_grads(g, ar, ac, feat, ct):
        out, vjp = jax.vjp(
            lambda *a: jax_gat(g, *a, negative_slope=0.2, attn_drop=p,
                               key=key, training=True), ar, ac, feat)
        return out, vjp(ct)

    out_j, grads_j = out_and_grads(jg, *(jnp.asarray(a) for a in arrs),
                                   jnp.asarray(ct))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out_t = gat_aggregate(tg, *ts, negative_slope=0.2, attn_drop=p,
                          seed=seed, training=True)
    out_t.backward(torch.from_numpy(ct))

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    for name_, t, gj in zip(("ar", "ac", "feat"), ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj),
                                   err_msg=name_, **GRAD_TOL)


@pytest.mark.parametrize("name", ["uniform", "power_law"])
def test_inference_path_matches_jax(rng, name):
    """No input needs a gradient: the primal-only path (no sign-split)."""
    jg, tg, arrs = _setup(rng, name, 2, 5)
    out_j = jax.jit(jax_gat)(jg, *(jnp.asarray(a) for a in arrs))
    calls = []
    orig = bins.bin_gat_fwd_plain

    def spy(*a, **kw):
        calls.append(kw["with_pos"])
        return orig(*a, **kw)

    bins.bin_gat_fwd_plain = spy
    try:
        out_t = gat_aggregate(tg, *(torch.from_numpy(a) for a in arrs),
                              negative_slope=0.2)
    finally:
        bins.bin_gat_fwd_plain = orig
    assert calls and not any(calls)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **FWD_TOL)


def test_zero_in_degree_rows_are_zero(rng):
    _, tg, arrs = _setup(rng, "zero_in_degree", 2, 3)
    out = gat_aggregate(tg, *(torch.from_numpy(a) for a in arrs))
    empty = np.diff(tg.row_ptr.numpy()) == 0
    assert torch.isfinite(out).all()
    assert (out[torch.from_numpy(empty)] == 0).all()


def test_refusals(rng):
    _, tg, arrs = _setup(rng, "uniform", 2, 3)
    ar, ac, feat = (torch.from_numpy(a) for a in arrs)
    with pytest.raises(ValueError, match="seed"):
        gat_aggregate(tg, ar, ac, feat, attn_drop=0.3, training=True)
    with pytest.raises(TypeError, match="float32"):
        gat_aggregate(tg, ar.double(), ac, feat)
