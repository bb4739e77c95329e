"""EdgeConv / DGCNN: the port (dgnn_tpu_torch) against the JAX package on
the CPU, where the port's wrappers take their plain versions, and, on a
CUDA device, the masked-max kernel against its plain version.

Inputs are made with numpy from a seed and handed to both sides.  JAX is
imported inside the JAX tests only, so that the CUDA tests run on a machine
without JAX:  python -m pytest --noconftest -m cuda
tests/test_torch_edgeconv.py
"""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dgnn_tpu_torch.data import load_modelnet, synthetic_point_clouds
from dgnn_tpu_torch.graph.knn import knn_graph, knn_mask_neg
from dgnn_tpu_torch.models import (DGCNN, BatchNorm, EdgeConv,
                                   flax_dgcnn_state_dict, load_flax_dgcnn)
from dgnn_tpu_torch.ops import ec_tiles, edgeconv
from dgnn_tpu_torch.ops.edgeconv import edge_conv_max, edge_conv_max_dense
from dgnn_tpu_torch.utils import cosine_lr, make_sgd_cosine, smoothed_loss

F32_TOL = dict(rtol=1e-5, atol=1e-6)    # float32 gradients: sums of a few g
BF16_TOL = dict(rtol=5e-3, atol=2e-2)   # mul_dtype bfloat16, as the JAX test
# The model: matrix products in another order on each side, four layers deep.
MODEL_TOL = dict(rtol=2e-4, atol=2e-5)
SMALL = dict(k=4, feature_dims=(8, 8), emb_dims=(16, 16, 8),
             output_classes=5)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _mask(rng, b, p, k, neg, dtype):
    """A random {0, neg} mask with k admitted columns per row."""
    cols = np.argsort(rng.random((b, p, p)), axis=-1)[..., :k]
    m = np.full((b, p, p), neg, np.float32)
    np.put_along_axis(m, cols, 0.0, axis=-1)
    return torch.from_numpy(m).to(dtype)


def _to_jax(t):
    import jax.numpy as jnp

    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_point_clouds_match_jax_package():
    from dgnn_tpu.data import synthetic as jsyn

    for kw in (dict(seed=0), dict(seed=3, template_seed=1),
               dict(seed=2, num_classes=7)):
        x, y = synthetic_point_clouds(6, 32, **kw)
        xj, yj = jsyn.synthetic_point_clouds(6, 32, **kw)
        assert x.dtype == np.float32 and y.dtype == np.int32
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(y, yj)


def test_load_modelnet_matches_jax_package(tmp_path, monkeypatch):
    from dgnn_tpu.data import load_modelnet as jload

    monkeypatch.setenv("DGNN_TPU_DATA", str(tmp_path))  # no file: synthetic
    got = load_modelnet(num_points=16, train_samples=5, test_samples=3,
                        seed=1)
    want = jload(num_points=16, train_samples=5, test_samples=3, seed=1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (5, 16, 3) and got[2].shape == (3, 16, 3)


# ---------------------------------------------------------------------------
# k-NN
# ---------------------------------------------------------------------------


def test_knn_graph_matches_jax(rng):
    import jax.numpy as jnp
    from dgnn_tpu.graph.knn import knn_graph as jknn

    x = _f32(rng, 2, 16, 3)
    got = knn_graph(torch.from_numpy(x), 4)
    want = np.asarray(jknn(jnp.asarray(x), 4))
    assert got.dtype == torch.int32 and tuple(got.shape) == (32, 4)
    # the same neighbour sets (continuous inputs: no ties), in top-k order
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [dict(exact=True), dict(),
                                dict(refine_iters=2),
                                dict(exact=True, dtype="float32", neg=-1e9)],
                         ids=["exact", "default", "refine2", "exact-f32"])
@pytest.mark.parametrize("shape", [(2, 32, 3, 4), (3, 40, 8, 6)],
                         ids=["points", "features"])
def test_knn_mask_neg_matches_jax(rng, kw, shape):
    import jax.numpy as jnp
    from dgnn_tpu.graph.knn import knn_mask_neg as jmask

    b, p, d, k = shape
    x = _f32(rng, b, p, d)
    kw = dict(kw)
    name = kw.pop("dtype", "bfloat16")
    got = knn_mask_neg(torch.from_numpy(x), k, dtype=getattr(torch, name),
                       **kw)
    want = jmask(jnp.asarray(x), k, dtype=getattr(jnp, name), **kw)
    assert got.dtype == getattr(torch, name)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    adm = (got == 0).sum(-1)
    assert int(adm.min()) >= k and bool((got.diagonal(dim1=1, dim2=2) == 0)
                                        .all())


# ---------------------------------------------------------------------------
# masked max (plain path on the CPU) against the JAX op's hot loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ec_tiles.SCHEDULES)
@pytest.mark.parametrize("dtype,neg", [(torch.bfloat16, -1e30),
                                       (torch.float32, -1e9)],
                         ids=["bf16", "f32"])
def test_masked_max_plain_matches_jax(rng, schedule, dtype, neg):
    from dgnn_tpu.ops.edgeconv import _masked_max, _masked_max_argmax

    b, p, f, k = 2, 12, 70, 4   # 70 columns: two of the JAX op's F chunks
    mask = _mask(rng, b, p, k, neg, dtype)
    mask[0, 3] = neg            # a row that admits nothing
    hs = _f32(rng, b, p, f)
    hs[1, 5] = hs[1, 2]         # a duplicated source row: exact ties
    mask[1, :, 2] = 0
    mask[1, :, 5] = 0
    hs_t = torch.from_numpy(hs)
    got = ec_tiles.masked_max(mask, hs_t, schedule=schedule)
    got_m, got_i = ec_tiles.masked_max(mask, hs_t, schedule=schedule,
                                       with_index=True)
    want = np.asarray(_masked_max(_to_jax(mask), _to_jax(hs_t)))
    want_m, want_i = _masked_max_argmax(_to_jax(mask), _to_jax(hs_t))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert ec_tiles.LAUNCHES == dict.fromkeys(ec_tiles.LAUNCHES, 0)
    # the empty row gives about neg, not -inf
    assert np.isfinite(got[0, 3].numpy()).all() and float(got[0, 3].max()) \
        < neg / 2


def test_masked_max_plain_walks_feature_chunks(rng, monkeypatch):
    mask = _mask(rng, 2, 12, 4, -1e30, torch.bfloat16)
    hs = torch.from_numpy(_f32(rng, 2, 12, 10))
    whole = ec_tiles.masked_max_plain(mask, hs, with_index=True)
    monkeypatch.setattr(ec_tiles, "_PLAIN_ELEMS", 12 * 12 * 3)
    parts = ec_tiles.masked_max_plain(mask, hs, with_index=True)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_masked_max_refuses_bad_arguments(rng):
    mask = _mask(rng, 1, 8, 3, -1e30, torch.bfloat16)
    hs = torch.from_numpy(_f32(rng, 1, 8, 4))
    with pytest.raises(ValueError):
        ec_tiles.masked_max(mask, hs, schedule="step4")
    with pytest.raises(ValueError):
        ec_tiles.masked_max(mask[:, :, :7], hs)
    with pytest.raises(TypeError):
        ec_tiles.masked_max(mask.to(torch.float16), hs)
    with pytest.raises(TypeError):
        ec_tiles.masked_max(mask, hs.to(torch.float64))


# ---------------------------------------------------------------------------
# the pruning rule of the kernels' list pass, stated in plain PyTorch
# ---------------------------------------------------------------------------


def _max_over_live(mask, hs):
    """masked_max_plain's two outputs taken over ``live_candidates`` alone:
    every other candidate is left out of the max and of the first-winner
    search."""
    live = ec_tiles.live_candidates(mask, hs)
    vals = mask.to(torch.float32)[:, :, :, None] + hs[:, None, :, :]
    vals = torch.where(live[..., None], vals, float("-inf"))
    m = vals.amax(dim=2)
    j = torch.arange(mask.shape[1], dtype=torch.int32)[None, None, :, None]
    first = torch.where(vals >= m[:, :, None, :], j, 1 << 20).amin(dim=2)
    return m, first.to(torch.int32), live


def _rule_case(rng, kind):
    """(mask, hs) for one named case of the pruning rule's tests."""
    b, p, f, k = 2, 24, 10, 5
    hs = _f32(rng, b, p, f)
    if kind in ("knn-bf16", "knn-f32"):
        dtype = torch.bfloat16 if kind == "knn-bf16" else torch.float32
        mask = knn_mask_neg(torch.from_numpy(_f32(rng, b, p, 3)), k,
                            dtype=dtype)
    elif kind == "empty-row":
        mask = _mask(rng, b, p, k, -1e30, torch.bfloat16)
        mask[0, 3] = -1e30
        mask[1, 0] = -1e30
    elif kind == "all-zero":
        mask = torch.zeros((b, p, p), dtype=torch.float32)
    elif kind == "general":
        mask = torch.from_numpy(_f32(rng, b, p, p) * 3)
    elif kind == "general-bf16":
        mask = torch.from_numpy(_f32(rng, b, p, p) * 3).to(torch.bfloat16)
    elif kind == "small-neg":         # neg = -1 beside hs of scale 10
        mask = _mask(rng, b, p, k, -1.0, torch.float32)
        hs = hs * 10
    elif kind == "large-hs":          # extremes near 1e30 / 4, no inf
        mask = _mask(rng, b, p, k, -1e30, torch.bfloat16)
        hs = hs * 1e29
        hs[0, 2, 1], hs[1, 5, 0] = 2.5e29, -2.5e29
    else:
        raise ValueError(kind)
    # a duplicated source row among the admitted ones: exact ties
    hs[1, 7] = hs[1, 1]
    mask[1, :, 1] = 0
    mask[1, :, 7] = 0
    return mask, torch.from_numpy(hs)


@pytest.mark.parametrize("kind", ["knn-bf16", "knn-f32", "empty-row",
                                  "all-zero", "general", "general-bf16",
                                  "small-neg", "large-hs"])
def test_max_over_live_candidates_equals_plain(rng, kind):
    """Tolerance: none.  The max and the first winner over the live set are
    masked_max_plain's bit for bit, whatever the mask holds."""
    mask, hs = _rule_case(rng, kind)
    want, want_i = ec_tiles.masked_max_plain(mask, hs, with_index=True)
    got, got_i, live = _max_over_live(mask, hs)
    assert torch.equal(got, want) and torch.equal(got_i, want_i)
    assert bool(torch.isfinite(want).all())
    n = live.sum(-1)
    assert int(n.min()) >= 1
    if kind.startswith("knn"):
        # on the model's masks the live set IS the admitted set
        assert torch.equal(live, mask == 0)
    elif kind == "empty-row":
        assert int(n[0, 3]) == mask.shape[1] and int(n[0, 4]) < 10
    elif kind in ("all-zero", "small-neg"):
        assert int(n.min()) == mask.shape[1]


@settings(max_examples=40, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1),
       values=st.sampled_from(["two", "three", "float", "rows"]),
       neg=st.sampled_from([-1e30, -1e9, -100.0, -1.0, -0.01, 0.5]),
       scale=st.sampled_from([1e-3, 1.0, 10.0, 1e29]),
       bf16=st.booleans())
def test_max_over_live_candidates_equals_plain_any_mask(seed, values, neg,
                                                        scale, bf16):
    """Masks drawn by hypothesis (two or three values, any floats, constant
    rows; any neg, any scale of h_src): exact, as above."""
    rng = np.random.default_rng(seed)
    b, p, f = 2, 12, 6
    pick = rng.random((b, p, p))
    if values == "two":
        m = np.where(pick < 0.3, 0.0, neg)
    elif values == "three":
        m = np.where(pick < 0.3, 0.0, np.where(pick < 0.6, neg, 2 * neg))
    elif values == "float":
        m = rng.normal(size=(b, p, p)) * abs(neg)
    else:
        m = np.broadcast_to(rng.normal(size=(b, p, 1)) * abs(neg), (b, p, p))
    mask = torch.from_numpy(np.ascontiguousarray(m, np.float32))
    if bf16:
        mask = mask.to(torch.bfloat16)
    hs = rng.normal(size=(b, p, f)).astype(np.float32) * np.float32(scale)
    hs[0, 4] = hs[0, 2]
    hs = torch.from_numpy(hs)
    want, want_i = ec_tiles.masked_max_plain(mask, hs, with_index=True)
    got, got_i, _ = _max_over_live(mask, hs)
    assert torch.equal(got, want) and torch.equal(got_i, want_i)


def test_live_counts_follow_the_rule_and_the_cap(rng):
    """On the CPU live_counts counts live_candidates; a row with more than
    LIVE_CAP of them is marked -1 (the kernel walks it densely)."""
    cap = ec_tiles.LIVE_CAP
    p = cap + 12
    mask = _mask(rng, 2, p, 6, -1e30, torch.bfloat16)
    mask[0, 2] = -1e30                       # admits nothing: all p are live
    mask[1, 5] = -1e30
    mask[1, 5, :cap] = 0                     # exactly the cap: still a list
    mask[1, 6] = -1e30
    mask[1, 6, 3:cap + 4] = 0                # one more
    hs = torch.from_numpy(_f32(rng, 2, p, 4))
    ec_tiles.reset_launches()
    got = ec_tiles.live_counts(mask, hs)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, p)
    want = (mask == 0).sum(-1).to(torch.int32)
    want[0, 2] = want[1, 6] = -1
    assert torch.equal(got, want)
    assert int(got[1, 5]) == cap and int(got.max()) == cap
    assert ec_tiles.LAUNCHES == dict.fromkeys(ec_tiles.LAUNCHES, 0)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


def _jax_dense_grads(mask, hs, hd, gout, mul_dtype, bwd_mode):
    import jax
    import jax.numpy as jnp
    from dgnn_tpu.ops.edgeconv import edge_conv_max_dense as jop

    jm = _to_jax(mask)
    dt = jnp.bfloat16 if mul_dtype == torch.bfloat16 else jnp.float32

    def loss(a, b):
        out = jop(jm, a, b, mul_dtype=dt, bwd_mode=bwd_mode)
        return jnp.sum(out * jnp.asarray(gout)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hs), jnp.asarray(hd))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_dense_grads(mask, hs, hd, gout, mul_dtype, bwd_mode):
    a = torch.from_numpy(hs).requires_grad_(True)
    b = torch.from_numpy(hd).requires_grad_(True)
    out = edge_conv_max_dense(mask, a, b, mul_dtype, bwd_mode)
    out.backward(torch.from_numpy(gout))
    return out.detach().numpy(), [a.grad.numpy(), b.grad.numpy()]


@pytest.mark.parametrize("bwd_mode", ["tie_sum", "argmax"])
@pytest.mark.parametrize("mul_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mask_kind", ["knn-bf16", "random-f32"])
def test_edge_conv_max_dense_matches_jax(rng, bwd_mode, mul_dtype,
                                         mask_kind):
    b, p, f = 2, 24, 70
    if mask_kind == "knn-bf16":
        # one mask, built once, handed to both sides
        mask = knn_mask_neg(torch.from_numpy(_f32(rng, b, p, 3)), 5)
    else:
        mask = _mask(rng, b, p, 5, -1e9, torch.float32)
    hs, hd, gout = (_f32(rng, b, p, f) for _ in range(3))
    out, grads = _torch_dense_grads(mask, hs, hd, gout, mul_dtype, bwd_mode)
    jout, jgrads = _jax_dense_grads(mask, hs, hd, gout, mul_dtype, bwd_mode)
    np.testing.assert_allclose(out, jout, rtol=1e-6, atol=1e-6)
    tol = F32_TOL if mul_dtype == torch.float32 else BF16_TOL
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, **tol)


@pytest.mark.parametrize("bwd_mode", ["tie_sum", "argmax"])
def test_edge_conv_max_dense_all_tied(rng, bwd_mode):
    """All sources identical, fully connected: argmax gives the whole
    gradient to source 0, tie_sum sums it over every tied source; both as
    the JAX op (tests/test_edgeconv_op.py)."""
    b, p, f = 1, 4, 3
    hs = np.zeros((b, p, f), np.float32)
    hd = _f32(rng, b, p, f)
    gout = np.ones((b, p, f), np.float32)
    mask = torch.zeros((b, p, p), dtype=torch.float32)
    _, (g, gd) = _torch_dense_grads(mask, hs, hd, gout, torch.float32,
                                    bwd_mode)
    _, (jg, jgd) = _jax_dense_grads(mask, hs, hd, gout, torch.float32,
                                    bwd_mode)
    np.testing.assert_allclose(g, jg)
    np.testing.assert_allclose(gd, jgd)
    if bwd_mode == "argmax":
        np.testing.assert_allclose(g[0, 0], p * np.ones(f))
        np.testing.assert_allclose(g[0, 1:], 0.0)
    else:
        np.testing.assert_allclose(g, p * np.ones((b, p, f)))


def test_edge_conv_max_dense_partial_ties_and_empty_row(rng):
    """A duplicated source row among a point's neighbours, and a row that
    admits nothing (every candidate of it ties at about neg): both modes as
    the JAX op."""
    b, p, f = 2, 10, 6
    mask = _mask(rng, b, p, 3, -1e30, torch.bfloat16)
    mask[0, 4] = -1e30
    mask[1, :, 1] = 0
    mask[1, :, 7] = 0
    hs, hd, gout = (_f32(rng, b, p, f) for _ in range(3))
    hs[1, 7] = hs[1, 1]
    for bwd_mode in ("tie_sum", "argmax"):
        out, grads = _torch_dense_grads(mask, hs, hd, gout, torch.float32,
                                        bwd_mode)
        jout, jgrads = _jax_dense_grads(mask, hs, hd, gout, torch.float32,
                                        bwd_mode)
        np.testing.assert_allclose(out, jout, rtol=1e-6)
        for g, jg in zip(grads, jgrads):
            np.testing.assert_allclose(g, jg, **F32_TOL)


def test_tie_sum_backward_walks_pair_slices(rng, monkeypatch):
    from dgnn_tpu_torch.ops import edgeconv

    mask = knn_mask_neg(torch.from_numpy(_f32(rng, 2, 16, 3)), 4)
    hs, hd, gout = (_f32(rng, 2, 16, 5) for _ in range(3))
    _, whole = _torch_dense_grads(mask, hs, hd, gout, torch.float32,
                                  "tie_sum")
    monkeypatch.setattr(edgeconv, "PAIR_BYTES", 4 * 5 * 7)  # 7 pairs a slice
    _, parts = _torch_dense_grads(mask, hs, hd, gout, torch.float32,
                                  "tie_sum")
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_tie_sum_backward_refuses_activations_near_neg(rng):
    """Activations within a factor 4 of the mask's neg, which the tie-sum
    backward refused while it told admitted from masked candidates by
    neg / 2, now get the JAX op's gradients, as argmax does."""
    mask = _mask(rng, 1, 8, 3, -1e9, torch.float32)
    hs, hd, gout = (_f32(rng, 1, 8, 4) for _ in range(3))
    hs[0, 2, 1] = 3e8
    hs[0, 5, 0] = -9e8
    for bwd_mode in ("tie_sum", "argmax"):
        out, grads = _torch_dense_grads(mask, hs, hd, gout, torch.float32,
                                        bwd_mode)
        jout, jgrads = _jax_dense_grads(mask, hs, hd, gout, torch.float32,
                                        bwd_mode)
        np.testing.assert_allclose(out, jout, rtol=1e-6)
        for g, jg in zip(grads, jgrads):
            np.testing.assert_allclose(g, jg, **F32_TOL)


def _full_columns(p):
    """(cloud, column) pairs that the "full-column" mask admits in every
    row."""
    return ((0, 2), (-1, p - 1))


def _raise_full_columns(hs, p, by=4.0):
    for bb, j in _full_columns(p):
        hs[bb, j] += by


def _tie_mask(rng, kind, b, p):
    """The masks on which tie_sum's pair filter must keep every hit."""
    if kind == "three-valued":
        # 0, -0.5 and -3 beside unit-scale activations: masked candidates
        # win rows, and sources tie under the same mask value
        pick = rng.random((b, p, p))
        m = np.where(pick < 0.3, 0.0, np.where(pick < 0.6, -0.5, -3.0))
    elif kind == "near-neg":
        # {0, neg} with activations above |neg| / 4
        m = _mask(rng, b, p, 3, -8.0, torch.float32).numpy()
    elif kind == "admits-nothing":
        m = _mask(rng, b, p, 3, -1e30, torch.float32).numpy()
        m[0, 4] = -1e30
        m[1, 2] = -1e30
    elif kind == "float":
        m = rng.normal(size=(b, p, p)) * 2
    elif kind == "full-column":
        # {0, -1e30} with a column that every row admits (_full_columns;
        # with h_src raised there, every row's filter passes it: over the
        # tie-sum lists' cap, so that the kernel walks it densely)
        m = _mask(rng, b, p, 3, -1e30, torch.float32).numpy()
        for bb, j in _full_columns(p):
            m[bb, :, j] = 0.0
    else:
        raise ValueError(kind)
    return torch.from_numpy(m.astype(np.float32))


@pytest.mark.parametrize("mul_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["three-valued", "near-neg",
                                  "admits-nothing", "float", "knn"])
def test_tie_sum_takes_any_mask(rng, kind, mul_dtype):
    """tie_sum's gradients equal the JAX op's for any float mask: three
    mask values, a {0, neg} mask with |h_src| above |neg| / 4, rows that
    admit nothing, unit-scale floats, and the model's k-NN mask (bf16,
    -1e30), on which the pair filter keeps what the admitted pairs did.
    Duplicated source rows make exact ties in every case."""
    b, p, f = 2, 12, 6
    hs, hd, gout = (_f32(rng, b, p, f) for _ in range(3))
    if kind == "knn":
        mask = knn_mask_neg(torch.from_numpy(_f32(rng, b, p, 3)), 4)
    else:
        mask = _tie_mask(rng, kind, b, p)
    if kind == "near-neg":
        hs *= 4.0
    hs[0, 5] = hs[0, 1]
    hs[1, 9] = hs[1, 3]
    out, grads = _torch_dense_grads(mask, hs, hd, gout, mul_dtype, "tie_sum")
    jout, jgrads = _jax_dense_grads(mask, hs, hd, gout, mul_dtype, "tie_sum")
    np.testing.assert_allclose(out, jout, rtol=1e-6, atol=1e-6)
    tol = F32_TOL if mul_dtype == torch.float32 else BF16_TOL
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, **tol)


@pytest.mark.parametrize("cap", [4, edgeconv.TIE_CAP])
@pytest.mark.parametrize("kind", ["three-valued", "near-neg",
                                  "admits-nothing", "float", "knn",
                                  "full-column"])
def test_tie_lists_hold_every_hit(rng, kind, cap):
    """The tie-sum list pass's plain version (the kernel's output format):
    a column's count is the number of rows that pass ``_dsrc_ties``'s
    filter; its list holds the first ``cap`` of them in ascending order
    with their mask values; and every hit of the column (any f with
    fl32(h_src[j, f] + mask[i, j]) == m[i, f], found densely here) is a
    listed row, or, past the cap, a row the dense walk finds.  Duplicated
    source rows make exact ties; a column admitted by every row overflows
    the cap."""
    b, p, f = 2, 12, 6
    hs = _f32(rng, b, p, f)
    if kind == "knn":
        mask = knn_mask_neg(torch.from_numpy(_f32(rng, b, p, 3)), 4)
    else:
        mask = _tie_mask(rng, kind, b, p)
    if kind == "near-neg":
        hs *= 4.0
    if kind == "full-column":
        _raise_full_columns(hs, p)
    hs[0, 5] = hs[0, 1]
    hs[1, 9] = hs[1, 3]
    hs = torch.from_numpy(hs)
    m = ec_tiles.masked_max(mask, hs)
    entries, count = edgeconv.tie_lists_plain(m, mask, hs, cap)
    mask32 = mask.to(torch.float32)
    # [B, i, j]: the filter, and the hits in any feature, both densely
    passes = (mask32 + hs.amax(-1)[:, None, :]) >= m.amin(-1)[:, :, None]
    hits = ((hs[:, None] + mask32[..., None]) == m[:, :, None]).any(-1)
    assert bool((hits <= passes).all())
    assert torch.equal(count, passes.sum(dim=1, dtype=torch.int32))
    if kind == "full-column":
        assert all(int(count[bb, j]) == p for bb, j in _full_columns(p))
    for bb in range(b):
        for j in range(p):
            rows = torch.nonzero(passes[bb, :, j]).flatten()
            n = min(int(count[bb, j]), cap)
            listed = entries[bb, j, :n]
            assert torch.equal(listed[:, 0], rows[:n].to(torch.int32))
            assert torch.equal(listed[:, 1].view(torch.float32),
                               mask32[bb, rows[:n], j])
            assert not bool(entries[bb, j, n:].any())
            hit_rows = torch.nonzero(hits[bb, :, j]).flatten()
            covered = rows if count[bb, j] > cap else rows[:n]
            assert bool(torch.isin(hit_rows, covered).all())


def test_edge_conv_max_dense_refuses_unknown_modes(rng):
    mask = torch.zeros((1, 4, 4))
    h = torch.zeros((1, 4, 2))
    with pytest.raises(ValueError):
        edge_conv_max_dense(mask, h, h, torch.float16)
    with pytest.raises(ValueError):
        edge_conv_max_dense(mask, h, h, bwd_mode="first")


def test_edge_conv_max_matches_jax(rng):
    import jax
    import jax.numpy as jnp
    from dgnn_tpu.ops.edgeconv import edge_conv_max as jop

    n, k, f = 30, 5, 7
    nbr = rng.integers(0, n, (n, k)).astype(np.int32)
    nbr[3] = nbr[3, 0]                      # one neighbour five times: ties
    hs, hd, gout = (_f32(rng, n, f) for _ in range(3))
    a = torch.from_numpy(hs).requires_grad_(True)
    b = torch.from_numpy(hd).requires_grad_(True)
    out = edge_conv_max(torch.from_numpy(nbr), a, b)
    out.backward(torch.from_numpy(gout))

    def loss(x, y):
        o = jop(jnp.asarray(nbr), x, y)
        return jnp.sum(o * jnp.asarray(gout)), o

    (_, jout), jg = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hs), jnp.asarray(hd))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jg[0]), **F32_TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jg[1]), **F32_TOL)


def test_edge_conv_max_walks_row_chunks(rng, monkeypatch):
    from dgnn_tpu_torch.ops import edgeconv

    n, k, f = 20, 3, 4
    nbr = torch.from_numpy(rng.integers(0, n, (n, k)).astype(np.int32))
    hs, hd = (torch.from_numpy(_f32(rng, n, f)) for _ in range(2))
    whole = edge_conv_max(nbr, hs, hd)
    monkeypatch.setattr(edgeconv, "PAIR_BYTES", 4 * k * f * 6)  # 6 rows
    assert torch.equal(edge_conv_max(nbr, hs, hd), whole)


def test_dense_path_matches_gather_path(rng):
    b, p, k, f = 2, 12, 4, 5
    x = torch.from_numpy(_f32(rng, b, p, 3))
    hs, hd = (torch.from_numpy(_f32(rng, b, p, f)) for _ in range(2))
    out_d = edge_conv_max_dense(knn_mask_neg(x, k, exact=True), hs, hd)
    out_g = edge_conv_max(knn_graph(x, k), hs.reshape(b * p, f),
                          hd.reshape(b * p, f))
    torch.testing.assert_close(out_d.reshape(b * p, f), out_g, rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize(tree, rng):
    """Flax variables with every leaf redrawn by numpy (batch stats and
    biases away from their 0 / 1 defaults; variances positive)."""
    import jax

    def draw(path, leaf):
        a = rng.normal(size=leaf.shape).astype(np.float32) * 0.5
        if path[-1].key in ("var", "scale"):
            a = np.abs(a) + 0.5
        return a

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_batch_norm_matches_flax(rng, training):
    import flax.linen as fnn
    import jax.numpy as jnp

    x = _f32(rng, 6, 5, 4) * 2.0 + 1.0
    fbn = fnn.BatchNorm(use_running_average=not training)
    variables = _randomize(_np_tree(fbn.init(
        __import__("jax").random.PRNGKey(0), jnp.asarray(x))), rng)
    want, upd = fbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(4)
    bn.load_state_dict({"scale": torch.from_numpy(variables["params"]["scale"]),
                        "bias": torch.from_numpy(variables["params"]["bias"]),
                        "mean": torch.from_numpy(
                            variables["batch_stats"]["mean"]),
                        "var": torch.from_numpy(
                            variables["batch_stats"]["var"])})
    bn.train(training)
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for key in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, key).numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-6)
    if training:  # the running stats moved, by 1 % of the way
        assert not np.allclose(bn.mean.numpy(),
                               variables["batch_stats"]["mean"])


@pytest.mark.parametrize("batch_norm", [False, True], ids=["plain", "bn"])
@pytest.mark.parametrize("path", ["dense", "gather"])
def test_edgeconv_layer_matches_flax(rng, batch_norm, path):
    import jax
    import jax.numpy as jnp
    from dgnn_tpu.models.dgcnn import EdgeConv as FEdgeConv

    b, p, c, f, k = 2, 16, 6, 10, 4
    x = _f32(rng, b, p, c)
    xt = torch.from_numpy(x)
    if path == "dense":
        adj, feat = knn_mask_neg(xt, k, exact=True), xt
        jadj, jfeat = _to_jax(adj), jnp.asarray(x)
    else:
        adj, feat = knn_graph(xt, k), xt.reshape(b * p, c)
        jadj, jfeat = jnp.asarray(adj.numpy()), jnp.asarray(x.reshape(-1, c))
    fmod = FEdgeConv(f, batch_norm=batch_norm)
    variables = _randomize(_np_tree(
        fmod.init(jax.random.PRNGKey(0), jadj, jfeat)), rng)
    want, upd = fmod.apply(variables, jadj, jfeat, training=True,
                           mutable=["batch_stats"])
    mod = EdgeConv(c, f, batch_norm=batch_norm)
    sd = flax_dgcnn_state_dict({"conv_0": variables["params"]},
                               {"conv_0": variables.get("batch_stats", {})})
    mod.load_state_dict({key.removeprefix("convs.conv_0."): v
                         for key, v in sd.items()}, strict=True)
    mod.train()
    got = mod(adj, feat)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    if batch_norm:
        stats = upd["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(mod.bn.mean.numpy(),
                                   np.asarray(stats["mean"]), **MODEL_TOL)
        np.testing.assert_allclose(mod.bn.var.numpy(),
                                   np.asarray(stats["var"]), **MODEL_TOL)


@pytest.fixture(scope="module")
def small_dgcnn():
    """The flax model at a small size with numpy-drawn variables, the port's
    model loaded from them, and a batch."""
    import jax
    import jax.numpy as jnp
    from dgnn_tpu.models import DGCNN as FDGCNN

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, 3)).astype(np.float32)
    y = np.array([1, 3], np.int32)
    fmodel = FDGCNN(dropout=0.0, **SMALL)
    variables = _randomize(_np_tree(
        fmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    model = load_flax_dgcnn(DGCNN(dropout=0.0, **SMALL), variables)
    return fmodel, variables, model, x, y


def _flax_masks(fmodel, variables, x, training):
    """The masks the flax model's layers built, by capturing the first
    argument of every EdgeConv call."""
    import jax.numpy as jnp
    from flax import linen as fnn
    from dgnn_tpu.models.dgcnn import EdgeConv as FEdgeConv

    masks = []

    def grab(next_fun, args, kwargs, context):
        if isinstance(context.module, FEdgeConv) \
                and context.method_name == "__call__":
            masks.append(np.asarray(args[0].astype(jnp.float32)))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(grab):
        fmodel.apply(variables, jnp.asarray(x), training=training,
                     mutable=["batch_stats"])
    return masks


def test_dgcnn_eval_logits_match_flax(small_dgcnn):
    import jax.numpy as jnp

    fmodel, variables, model, x, _ = small_dgcnn
    model.eval()
    masks = []
    with torch.no_grad():
        got = model(torch.from_numpy(x), masks_out=masks)
    # the masks first, layer by layer, so that a failure says where
    want_masks = _flax_masks(fmodel, variables, x, training=False)
    assert len(masks) == len(want_masks) == len(SMALL["feature_dims"])
    for i, (m, wm) in enumerate(zip(masks, want_masks)):
        np.testing.assert_array_equal(m.to(torch.float32).numpy(), wm,
                                      err_msg=f"mask of layer {i}")
    want = fmodel.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    # handing the masks in gives the same logits
    with torch.no_grad():
        again = model(torch.from_numpy(x), masks=masks)
    assert torch.equal(again, got)


def test_dgcnn_train_step_matches_flax(small_dgcnn):
    """One training step with dropout 0: loss, every parameter gradient, the
    parameters and the running batch stats after the SGD step."""
    import copy

    import jax
    import jax.numpy as jnp
    import optax

    fmodel, variables, model, x, y = small_dgcnn
    model = copy.deepcopy(model).train()
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        logits, upd = fmodel.apply({"params": p, "batch_stats": stats},
                                   jnp.asarray(x), training=True,
                                   mutable=["batch_stats"])
        n_cls = logits.shape[1]
        one_hot = jax.nn.one_hot(jnp.asarray(y), n_cls)
        smooth = one_hot * 0.8 + (1 - one_hot) * 0.2 / (n_cls - 1)
        loss = -(smooth * jax.nn.log_softmax(logits, axis=1)).sum(1).mean()
        return loss, upd["batch_stats"]

    (jloss, new_stats), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    tx = optax.chain(optax.add_decayed_weights(1e-4),
                     optax.sgd(optax.cosine_decay_schedule(0.1, 8, alpha=0.01),
                               momentum=0.9))
    updates, _ = tx.update(jgrads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)

    opt = make_sgd_cosine(model, 8)
    loss = smoothed_loss(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want_g = flax_dgcnn_state_dict(_np_tree(jgrads), _np_tree(new_stats))
    named = dict(model.named_parameters())
    assert set(named) | {k for k in want_g if k.endswith((".mean", ".var"))} \
        == set(want_g)
    for key, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_g[key].numpy(),
                                   err_msg=f"gradient of {key}", **MODEL_TOL)
    opt.step()
    want_sd = flax_dgcnn_state_dict(_np_tree(new_params), _np_tree(new_stats))
    got_sd = model.state_dict()
    assert set(got_sd) == set(want_sd)
    for key, v in got_sd.items():
        np.testing.assert_allclose(v.numpy(), want_sd[key].numpy(),
                                   err_msg=f"{key} after the step",
                                   **MODEL_TOL)
    # the running stats did move
    assert not np.allclose(got_sd["bns.bn_1.mean"].numpy(),
                           np.asarray(stats["bn_1"]["mean"]))


def test_dgcnn_init_follows_flax_defaults():
    model = DGCNN(generator=torch.Generator().manual_seed(0), **SMALL)
    for name, p in model.state_dict().items():
        if name.endswith("bias"):
            assert float(p.abs().max()) == 0.0, name
        elif name.endswith("scale"):
            assert float((p - 1).abs().max()) == 0.0, name
    w = model.proj.weight.detach()          # lecun normal: var 1 / fan_in
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.15
    again = DGCNN(generator=torch.Generator().manual_seed(0), **SMALL)
    assert torch.equal(again.head.weight, model.head.weight)
    with pytest.raises(ValueError):         # dropout needs a generator
        model.train()(torch.zeros(2, 8, 3))


def test_flax_dgcnn_state_dict_refuses_unknown_entries():
    with pytest.raises(ValueError):
        flax_dgcnn_state_dict({"conv_0": {"theta": {"kernel": np.zeros((3, 2))},
                                          "phi": {"kernel": np.zeros((3, 2))},
                                          "psi": {}}})
    with pytest.raises(ValueError):
        flax_dgcnn_state_dict({"pool": {"kernel": np.zeros((3, 2))}})


# ---------------------------------------------------------------------------
# loss and schedule
# ---------------------------------------------------------------------------


def test_smoothed_loss_matches_jax_trainer(rng):
    import jax
    import jax.numpy as jnp

    logits = _f32(rng, 6, 5) * 3
    y = rng.integers(0, 5, 6).astype(np.int32)
    for eps in (0.2, 0.0, 0.5):
        one_hot = jax.nn.one_hot(jnp.asarray(y), 5)
        smooth = one_hot * (1 - eps) + (1 - one_hot) * eps / 4
        want = -(smooth * jax.nn.log_softmax(jnp.asarray(logits),
                                             axis=1)).sum(1).mean()
        got = smoothed_loss(torch.from_numpy(logits), torch.from_numpy(y),
                            eps)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # and it is not torch's label smoothing, which spreads eps over all n
    other = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(y).long(),
        label_smoothing=0.2)
    assert abs(float(other) - float(smoothed_loss(
        torch.from_numpy(logits), torch.from_numpy(y)))) > 1e-3


def test_cosine_schedule_matches_optax(rng):
    """The trainer's optimizer (SGDCosine: its step count and learning rate
    on the parameters' device) against optax.chain(add_decayed_weights(1e-4),
    sgd(cosine_decay_schedule(0.1, 16, alpha=0.01), momentum=0.9)) over 24
    steps of numpy-made gradients, past the cosine's end: the learning rate
    and every parameter within rtol 1e-6 (float32 on both sides, the same
    operations in the same order)."""
    import jax.numpy as jnp
    import optax

    sched = optax.cosine_decay_schedule(0.1, 16, alpha=0.01)
    tx = optax.chain(optax.add_decayed_weights(1e-4),
                     optax.sgd(sched, momentum=0.9))
    model = torch.nn.Linear(5, 3)
    opt = make_sgd_cosine(model, 16)
    params = {k: jnp.asarray(v.detach().numpy().copy())
              for k, v in model.named_parameters()}
    state = tx.init(params)
    for step in range(24):
        np.testing.assert_allclose(cosine_lr(step, 16), float(sched(step)),
                                   rtol=1e-6)
        lr = opt.lr()
        assert lr.dtype == torch.float32 and lr.device == opt.count.device
        np.testing.assert_allclose(float(lr), float(sched(step)), rtol=1e-6)
        np.testing.assert_allclose(
            float(cosine_lr(torch.tensor(step), 16)), float(sched(step)),
            rtol=1e-6)
        grads = {k: _f32(rng, *v.shape) for k, v in params.items()}
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        updates, state = tx.update({k: jnp.asarray(v) for k, v in
                                    grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k}, step {step}")
    assert int(opt.count) == 24
    assert abs(cosine_lr(16, 16) - 0.001) < 1e-9


# ---------------------------------------------------------------------------
# the trainer, on the CPU
# ---------------------------------------------------------------------------


def _load_script(name):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" \
        / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_trainer():
    return _load_script("train_edgeconv_torch")


def test_trainer_runs_on_cpu(tmp_path, monkeypatch):
    from dgnn_tpu_torch.ops import edgeconv

    trainer = _load_trainer()
    # a short timing signal: at the CLI's 2 s the timing loops only run
    # longer on the host
    monkeypatch.setattr(trainer, "MIN_SIGNAL_S", 0.05)
    out = tmp_path / "rows.csv"
    args = trainer.parser().parse_args(
        ["--device", "cpu", "--num-epochs", "2", "--batch-size", "4",
         "--k", "4", "--num-points", "16", "--train-samples", "16",
         "--test-samples", "8", "--output", str(out)])
    ec_tiles.reset_launches()
    edgeconv.reset_launches()
    r = trainer.run(args)
    # 2 epochs of 4 steps trained; the timing copy's warmup epoch and its
    # timed epochs beside them, counted where they ran
    assert r["steps_per_epoch"] == 4 and len(r["losses"]) == 8
    assert r["train_steps"] >= 8 + 4 * (trainer.WARMUP_EPOCHS
                                        + trainer.TIME_EPOCHS)
    assert (r["train_steps"] - 8) % 4 == 0
    assert all(np.isfinite(r["losses"]))
    assert np.isfinite([r["epoch_loss"], r["epoch_acc"]]).all()
    # the last epoch's mean loss is the mean of its steps' losses
    np.testing.assert_allclose(r["epoch_loss"], np.mean(r["losses"][4:]),
                               rtol=1e-6)
    # two test batches a pass: the warmup pass and at least num_epochs
    # timed ones
    assert r["infer_passes"] >= 1 + 2
    assert r["eval_batches"] == 2 * r["infer_passes"]
    assert 0.0 <= r["test_acc"] <= 1.0
    assert ec_tiles.LAUNCHES == dict.fromkeys(ec_tiles.LAUNCHES, 0)
    assert edgeconv.LAUNCHES == dict.fromkeys(edgeconv.LAUNCHES, 0)
    assert "train_edgeconv_dgnn_tpu_torch,4 4," in out.read_text()
    # the schedule reached its end: lr 0.001 after num_epochs * steps, a
    # float32 on the device
    assert np.float32(r["last_lr"]) == np.float32(cosine_lr(8, 8))


def test_trainer_refuses_checkpoint_flags(tmp_path):
    """The checkpoint flags work (tests/test_torch_checkpoint.py); a
    checkpoint that does not fit the model is refused before training."""
    from dgnn_tpu_torch.utils import CheckpointManager

    trainer = _load_trainer()
    CheckpointManager(str(tmp_path)).save(1, {"w": torch.zeros(3)})
    for flag in ("--save-model-path", "--load-model-path"):
        args = trainer.parser().parse_args(
            ["--device", "cpu", "--num-epochs", "2", "--batch-size", "4",
             "--k", "4", "--num-points", "16", "--train-samples", "16",
             "--test-samples", "8", "--load-model-path", str(tmp_path)]
            + ([flag, str(tmp_path)] if flag == "--save-model-path" else []))
        with pytest.raises(ValueError, match="keys"):
            trainer.run(args)


@pytest.mark.parametrize("mask,dtype,neg", [("f32", torch.float32, -1e9),
                                            ("knn", torch.bfloat16, -1e30)])
def test_ec_tiles_study_runs_on_cpu(mask, dtype, neg):
    """The masked-max study script at a small size: the plain version only
    (a CPU tensor never reaches a kernel), exact, with the study's mask or
    the model's."""
    study = _load_script("exp_ec_tiles_torch")
    m, hs = study.make_inputs("cpu", 2, 16, 5, 3, mask)
    assert m.dtype == dtype and tuple(m.shape) == (2, 16, 16)
    assert set(m.to(torch.float32).unique().tolist()) \
        == {0.0, float(torch.tensor(neg, dtype=dtype))}
    ec_tiles.reset_launches()
    res = study.study("cpu", 2, 16, 5, 3, mask, iters=1)
    assert [r["variant"] for r in res["rows"]] == ["plain"]
    assert res["rows"][0]["max_abs_err"] == 0.0 and res["rows"][0]["ms"] > 0
    if mask == "knn":
        assert res["shape"]["admitted_per_row"] >= 3
    assert ec_tiles.LAUNCHES == dict.fromkeys(ec_tiles.LAUNCHES, 0)


# ---------------------------------------------------------------------------
# on a CUDA device: the kernel against its plain version
# ---------------------------------------------------------------------------


def _adversarial_mask(rng, kind, b, p, k, dtype, neg):
    """The masks the list pass must get right beside the k-NN ones."""
    if kind == "knn":
        mask = _mask(rng, b, p, min(k, p), neg, dtype)
        mask[0, 1] = neg                     # a row that admits nothing
    elif kind == "all-zero":
        mask = torch.zeros((b, p, p), dtype=dtype)
    elif kind == "general":
        mask = torch.from_numpy(_f32(rng, b, p, p) * 3).to(dtype)
    elif kind == "small-neg":
        mask = _mask(rng, b, p, min(k, p), -1.0, dtype)
    elif kind == "overflow":
        # one row just over the list's cap (where P allows), one at it
        mask = _mask(rng, b, p, min(k, p), neg, dtype)
        mask[0, 2] = mask[0, 4] = neg
        mask[0, 2, :ec_tiles.LIVE_CAP + 1] = 0
        mask[0, 4, 1:ec_tiles.LIVE_CAP + 1] = 0
    else:
        raise ValueError(kind)
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ec_tiles.SCHEDULES)
@pytest.mark.parametrize("kind", ["knn", "all-zero", "general", "small-neg",
                                  "overflow"])
@pytest.mark.parametrize("shape", [(2, 256, 64), (1, 100, 70), (3, 12, 5),
                                   (2, 1000, 70)],
                         ids=["tiles", "ragged", "tiny", "p1000-f70"])
def test_cuda_masked_max_matches_plain(rng, cuda_device, schedule, shape,
                                       kind):
    """Tolerance: none, value and first-winner index, both mask dtypes."""
    b, p, f = shape
    for dtype, neg in ((torch.bfloat16, -1e30), (torch.float32, -1e9)):
        mask = _adversarial_mask(rng, kind, b, p, 5, dtype, neg)
        hs = _f32(rng, b, p, f) * (10 if kind == "small-neg" else 1)
        hs[0, 3] = hs[0, 0]
        mask[0, :, 0] = 0
        mask[0, :, 3] = 0
        mask, hs = mask.to(cuda_device), torch.from_numpy(hs).to(cuda_device)
        ec_tiles.reset_launches()
        got = ec_tiles.masked_max(mask, hs, schedule=schedule)
        got_m, got_i = ec_tiles.masked_max(mask, hs, schedule=schedule,
                                           with_index=True)
        torch.cuda.synchronize()
        assert ec_tiles.LAUNCHES["masked_max_" + schedule] == 2
        assert ec_tiles.LAUNCHES["masked_max_live_lists"] == 2
        want_m, want_i = ec_tiles.masked_max_plain(mask, hs, with_index=True)
        assert torch.equal(got, want_m) and torch.equal(got_m, want_m)
        assert torch.equal(got_i, want_i)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["knn", "all-zero", "general", "small-neg",
                                  "overflow"])
@pytest.mark.parametrize("shape", [(2, 256, 64), (2, 1000, 70), (3, 12, 5)],
                         ids=["tiles", "p1000-f70", "tiny"])
def test_cuda_live_counts_match_the_rule(rng, cuda_device, shape, kind):
    """The list pass on the card counts exactly live_candidates' columns."""
    b, p, f = shape
    for dtype, neg in ((torch.bfloat16, -1e30), (torch.float32, -1e9)):
        mask = _adversarial_mask(rng, kind, b, p, 5, dtype, neg).to(
            cuda_device)
        hs = torch.from_numpy(_f32(rng, b, p, f)).to(cuda_device)
        ec_tiles.reset_launches()
        got = ec_tiles.live_counts(mask, hs)
        torch.cuda.synchronize()
        assert ec_tiles.LAUNCHES == {**dict.fromkeys(ec_tiles.LAUNCHES, 0),
                                     "masked_max_live_lists": 1}
        n = ec_tiles.live_candidates(mask, hs).sum(-1, dtype=torch.int32)
        want = torch.where(n > ec_tiles.LIVE_CAP, -1, n).to(torch.int32)
        assert torch.equal(got, want)
        if kind == "overflow" and p > ec_tiles.LIVE_CAP:
            assert int(got[0, 2]) == -1 and int(got[0, 4]) >= 0


@pytest.mark.cuda
def test_cuda_masked_max_refuses_what_the_kernel_does_not_take(rng,
                                                               cuda_device):
    mask = _mask(rng, 1, 8, 3, -1e30, torch.bfloat16).to(cuda_device)
    hs = torch.from_numpy(_f32(rng, 1, 8, 4)).to(cuda_device)
    with pytest.raises(ValueError):
        ec_tiles.masked_max(mask.transpose(1, 2), hs)
    with pytest.raises(ValueError):
        ec_tiles.masked_max(mask.cpu(), hs)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [64, 300])
@pytest.mark.parametrize("kind", ["three-valued", "near-neg",
                                  "admits-nothing", "float", "full-column"])
def test_cuda_tie_sum_any_mask_matches_cpu(rng, cuda_device, kind, p):
    """The tie-sum backward's pair filter on the card against the CPU, on
    the masks a {0, neg} rule would get wrong and on columns every row
    admits (over the lists' cap at P = 300), at a P on and off the
    kernels' tiles; on the op's own m the kernels equal ``_dsrc_ties`` bit
    for bit, and two calls each other."""
    b, f = 2, 40
    mask = _tie_mask(rng, kind, b, p)
    hs, hd, gout = (_f32(rng, b, p, f) for _ in range(3))
    if kind == "near-neg":
        hs *= 4.0
    if kind == "full-column":
        _raise_full_columns(hs, p)
    hs[0, 5] = hs[0, 1]
    _, want = _torch_dense_grads(mask, hs, hd, gout, torch.float32, "tie_sum")
    a = torch.from_numpy(hs).to(cuda_device).requires_grad_(True)
    bb = torch.from_numpy(hd).to(cuda_device).requires_grad_(True)
    out = edge_conv_max_dense(mask.to(cuda_device), a, bb, torch.float32,
                              "tie_sum")
    out.backward(torch.from_numpy(gout).to(cuda_device))
    for g, w in zip((a.grad, bb.grad), want):
        np.testing.assert_allclose(g.cpu().numpy(), w, **F32_TOL)
    m = ec_tiles.masked_max(mask.to(cuda_device), a.detach())
    g = torch.from_numpy(gout).to(cuda_device)
    for mul_dtype in edgeconv.MUL_DTYPES:
        got = edgeconv.tie_sum_bwd(m, mask.to(cuda_device), a.detach(), g,
                                   mul_dtype)
        again = edgeconv.tie_sum_bwd(m, mask.to(cuda_device), a.detach(), g,
                                     mul_dtype)
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), edgeconv._dsrc_ties(
            m.cpu(), mask, torch.from_numpy(hs), g.cpu(), mul_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("bwd_mode", ["tie_sum", "argmax"])
def test_cuda_edge_conv_max_dense_matches_cpu(rng, cuda_device, bwd_mode):
    b, p, f = 2, 64, 96
    mask = knn_mask_neg(torch.from_numpy(_f32(rng, b, p, 3)), 8)
    hs, hd, gout = (_f32(rng, b, p, f) for _ in range(3))
    _, want = _torch_dense_grads(mask, hs, hd, gout, torch.float32, bwd_mode)
    a = torch.from_numpy(hs).to(cuda_device).requires_grad_(True)
    bb = torch.from_numpy(hd).to(cuda_device).requires_grad_(True)
    out = edge_conv_max_dense(mask.to(cuda_device), a, bb, torch.float32,
                              bwd_mode)
    out.backward(torch.from_numpy(gout).to(cuda_device))
    for g, w in zip((a.grad, bb.grad), want):
        np.testing.assert_allclose(g.cpu().numpy(), w, **F32_TOL)
