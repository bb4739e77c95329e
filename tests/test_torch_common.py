"""dgnn_tpu_torch.ops.common against dgnn_tpu.ops.common: the dropout hash
bit for bit, the segment merges on partials with overflow rows."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgnn_tpu.graph import binning as jbinning
from dgnn_tpu.graph.structure import CombineTable as JCombineTable
from dgnn_tpu.ops import common as jcommon
from dgnn_tpu_torch.graph.structure import CombineTable
from dgnn_tpu_torch.ops import common


@pytest.mark.parametrize("num_heads,p", [(1, 0.3), (4, 0.5), (3, 0.1)])
def test_pair_keep_bit_identical(rng, num_heads, p):
    # ids and seeds span the whole uint32 range, including >= 2^31
    dst = rng.integers(0, 2 ** 32, size=(64, 1), dtype=np.uint64)
    src = rng.integers(0, 2 ** 32, size=(64, 9), dtype=np.uint64)
    dst[:4, 0] = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    for seed in [0, 7, 2 ** 31 + 5, 2 ** 32 - 1,
                 int(rng.integers(0, 2 ** 32))]:
        want = jcommon.pair_keep(jnp.uint32(seed),
                                 jnp.asarray(dst.astype(np.uint32)),
                                 jnp.asarray(src.astype(np.uint32)),
                                 num_heads, p)
        got = common.pair_keep(seed, torch.from_numpy(dst.astype(np.int64)),
                               torch.from_numpy(src.astype(np.int64)),
                               num_heads, p)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pair_keep_int32_ids_match(rng):
    """int32 node ids (what the bin tables hold) hash as their uint32."""
    dst = rng.integers(0, 5000, size=(40, 1)).astype(np.int32)
    src = rng.integers(0, 5000, size=(40, 6)).astype(np.int32)
    want = jcommon.pair_keep(jnp.uint32(123456789), jnp.asarray(dst),
                             jnp.asarray(src), 4, 0.3)
    got = common.pair_keep(123456789, torch.from_numpy(dst),
                           torch.from_numpy(src), 4, 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tables(rng, num_rows=300):
    """Combine tables with overflow rows: a few rows own many segments."""
    seg_rows = np.concatenate([
        np.arange(num_rows),                       # one segment per row
        rng.integers(0, num_rows, 40),             # second segments
        np.repeat(rng.choice(num_rows, 70, replace=False), 3),  # overflow
    ])
    rng.shuffle(seg_rows)
    valid = rng.random(seg_rows.shape[0]) > 0.05  # some padding segments
    main, ov_rows, ov = jbinning.combine_tables(seg_rows, num_rows, valid)
    assert ov_rows.shape[0] > 0 and main.shape[1] >= 1
    return seg_rows.shape[0], main, ov_rows, ov


def _both(main, ov_rows, ov):
    j = JCombineTable(main=jnp.asarray(main), ov_rows=jnp.asarray(ov_rows),
                      ov=jnp.asarray(ov))
    t = CombineTable(main=torch.from_numpy(main),
                     ov_rows=torch.from_numpy(ov_rows),
                     ov=torch.from_numpy(ov))
    return j, t


def test_combine_sum_matches(rng):
    S, main, ov_rows, ov = _tables(rng)
    jt, tt = _both(main, ov_rows, ov)
    a = rng.normal(size=(S, 3, 5)).astype(np.float32)
    b = rng.normal(size=(S, 3)).astype(np.float32)
    want = jcommon.combine_sum(jt, [jnp.asarray(a), jnp.asarray(b)])
    got = common.combine_sum(tt, [torch.from_numpy(a), torch.from_numpy(b)])
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    single = common.combine_sum(tt, torch.from_numpy(b))
    np.testing.assert_allclose(single.numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)


def test_combine_lse_matches(rng):
    S, main, ov_rows, ov = _tables(rng)
    jt, tt = _both(main, ov_rows, ov)
    H, F = 2, 4
    m = rng.normal(size=(S, H)).astype(np.float32) * 3
    m[rng.random(S) < 0.1] = -1e30  # empty segments (kernel sentinel)
    parts = [rng.random((S, H)).astype(np.float32),
             rng.normal(size=(S, H, F)).astype(np.float32)]
    M_j, outs_j = jcommon.combine_lse(jt, jnp.asarray(m),
                                      [jnp.asarray(x) for x in parts])
    M_t, outs_t = common.combine_lse(tt, torch.from_numpy(m),
                                     [torch.from_numpy(x) for x in parts])
    np.testing.assert_array_equal(M_t.numpy(), np.asarray(M_j))
    for w, g in zip(outs_j, outs_t):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_lane_mask_and_leaky_relu(rng):
    count = rng.integers(0, 9, 20).astype(np.int32)
    np.testing.assert_array_equal(
        common.lane_mask(torch.from_numpy(count), 8).numpy(),
        np.asarray(jcommon.lane_mask(jnp.asarray(count), 8)))
    x = rng.normal(size=(50,)).astype(np.float32)
    x[:3] = [0.0, -0.0, 1e-30]
    np.testing.assert_array_equal(
        common.leaky_relu(torch.from_numpy(x), 0.2).numpy(),
        np.asarray(jcommon.leaky_relu(jnp.asarray(x), 0.2)))
    np.testing.assert_array_equal(
        common.leaky_relu_grad(torch.from_numpy(x), 0.2).numpy(),
        np.asarray(jcommon.leaky_relu_grad(jnp.asarray(x), 0.2)))
    m = torch.tensor([-1e30, -float("inf"), -1e28, 0.0])
    assert common.is_empty_m(m).tolist() == [True, True, False, False]
