"""The port's partition_graph against the JAX package's, array for array,
and the shard views the ranks take from it."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import numpy as np
import pytest
import torch

from dgnn_tpu.parallel import partition_graph as jax_partition_graph
from dgnn_tpu_torch.graph.hub import DENSE_RT
from dgnn_tpu_torch.parallel import partition_graph, shard_view
from tests.conftest import random_graph


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _bins_eq(mine, ref, what):
    assert mine.widths == ref.widths, what
    assert (mine.num_rows, mine.num_edges) == (ref.num_rows, ref.num_edges)
    for name in ("nbr", "edge", "row", "count"):
        mt, rt = getattr(mine, name), getattr(ref, name)
        assert len(mt) == len(rt), (what, name)
        for b, (x, y) in enumerate(zip(mt, rt)):
            _eq(x, y, f"{what}.{name}[{b}]")


@pytest.mark.parametrize("widths", [(4, 16), None], ids=["widths", "auto"])
@pytest.mark.parametrize("dense", [None, (8, 24), "auto"],
                         ids=["nodense", "forced", "planned"])
@pytest.mark.parametrize("num_shards", [2, 4])
@pytest.mark.parametrize("power_law", [False, True],
                         ids=["uniform", "powerlaw"])
def test_partition_matches_jax(rng, power_law, num_shards, dense, widths):
    n = 48 if power_law else 40
    src, dst = random_graph(rng, n, 6 if power_law else 4,
                            power_law=power_law)
    ref = jax_partition_graph(src, dst, n, num_shards, widths=widths,
                              dense=dense)
    mine = partition_graph(src, dst, n, num_shards, widths=widths,
                           dense=dense)
    for key in ("num_shards", "nodes_per_shard", "halo_max", "num_nodes"):
        assert getattr(mine, key) == getattr(ref, key), key
    for key in ("fwd_local", "fwd_halo", "bwd"):
        _bins_eq(getattr(mine, key), getattr(ref, key), key)
    for key in ("send_ids", "ext_gids", "edge_gids"):
        _eq(getattr(mine, key), getattr(ref, key), key)
    for key in ("fwd_cmb", "bwd_cmb"):
        for name in ("main", "ov_rows", "ov"):
            _eq(getattr(getattr(mine, key), name),
                getattr(getattr(ref, key), name), f"{key}.{name}")
    for key in ("fwd_dense", "bwd_dense"):
        md, rd = getattr(mine, key), getattr(ref, key)
        assert (md is None) == (rd is None), key
        if md is not None:
            for name in ("row_ids", "col_ids", "mask", "rc", "ct", "first"):
                _eq(getattr(md, name), getattr(rd, name), f"{key}.{name}")
    if dense == (8, 24):
        assert mine.fwd_dense is not None and mine.bwd_dense is not None


def test_shard_view_layout(rng):
    """A view is its shard's slice of the stacked layout: local ++ halo
    bins, the combine tables' row counts, the hub block's chunk pointers
    over every padded row chunk, int32 tables."""
    n, num_shards = 48, 4
    src, dst = random_graph(rng, n, 6, power_law=True)
    shards = partition_graph(src, dst, n, num_shards, widths=(4, 16),
                             dense=(8, 24))
    c, ext = shards.nodes_per_shard, shards.ext_size
    for p in range(num_shards):
        v = shard_view(shards, p)
        assert v.fwd.num_rows == c and v.bwd.num_rows == ext
        assert v.fwd.widths == (shards.fwd_local.widths
                                + shards.fwd_halo.widths)
        assert v.fwd.cmb.main.shape[0] == c
        assert v.bwd.cmb.main.shape[0] == ext
        assert tuple(v.send_ids.shape) == (num_shards, shards.halo_max)
        assert v.ext_gids.dtype == torch.int32
        assert v.rows == slice(p * c, (p + 1) * c)
        for db in (v.fwd.dense, v.bwd.dense):
            n_chunks = db.row_ids.shape[0] // DENSE_RT
            ptr = db.chunk_ptr.tolist()
            assert len(ptr) == n_chunks + 1 and ptr[-1] == db.rc.shape[0]
            assert ptr == sorted(ptr)
            # every schedule entry lies in its row chunk's range
            for t, rc in enumerate(db.rc.tolist()):
                assert ptr[rc] <= t < ptr[rc + 1]
