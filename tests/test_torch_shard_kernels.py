"""The GAT kernels' global-id form (``gid``) on a graph shard's layout:
the plain versions here, the kernels against them on the card.

On a shard the bins' rows are local ids and their slots extended ids; the
dropout hash must read both through the shard's ext_gids, and every
gather must keep the shard's own ids.  Run the card's tests on a machine
without JAX:  python -m pytest --noconftest -m cuda
tests/test_torch_shard_kernels.py
"""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import numpy as np
import pytest
import torch

from dgnn_tpu_torch.ops import bins, dense
from dgnn_tpu_torch.ops.common import pair_keep
from dgnn_tpu_torch.parallel import partition_graph, shard_view

SLOPE = 0.2
SEED = 0x9E3779B9
P_DROP = 0.3
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def rng():
    # defined here too: the card's runs skip tests/conftest.py (it imports
    # JAX, which the card's machine does not have)
    return np.random.default_rng(0)


def _power_law_edges(rng, n, deg):
    e = n * deg
    src = rng.integers(0, n, e)
    dst = np.minimum(rng.zipf(1.6, e) - 1, n - 1)
    uniq = np.unique(np.stack([src, dst], 1), axis=0)
    return uniq[:, 0], uniq[:, 1]


def _shard(rng, p=1, n=300, deg=8, num_shards=4, dense_rc=(16, 40)):
    src, dst = _power_law_edges(rng, n, deg)
    shards = partition_graph(src, dst, n, num_shards, widths=(4, 16),
                             dense=dense_rc)
    return shards, shard_view(shards, p)


def _tables(rng, view, h, f):
    """Node tables of one shard: destinations are its C rows, sources its
    C + P*Hmax extended rows."""
    c, ext = view.nodes_per_shard, view.ext_size

    def t(*shape, lo=None):
        x = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(np.abs(x) + lo if lo is not None else x)

    return dict(feat=t(ext, h, f), ac=t(ext, h), ar=t(c, h),
                g=t(c, h, f) / 16, M=t(c, h, lo=1.0), Linv=t(c, h, lo=0.1),
                ws=t(c, h))


def _fwd(tb, view, fn, gid, **kw):
    return fn(tb["feat"], tb["ac"], tb["ar"], view.fwd.segs(), slope=SLOPE,
              with_pos=True, p=P_DROP, seed=SEED, gid=gid, **kw)


def _bwd(tb, view, fn, gid, **kw):
    return fn(tb["g"], tb["ar"], tb["M"], tb["Linv"], tb["ws"], tb["ac"],
              tb["feat"], view.bwd.segs(), slope=SLOPE, p=P_DROP, seed=SEED,
              gid=gid, **kw)


def test_plain_gid_is_the_hash_of_the_translated_ids(rng):
    """The plain versions with a gid table hash gid[row], gid[slot] (and
    gid[row_ids], gid[col_ids] in the hub block), and gather by the
    shard's own ids: with the identity table they equal the versions
    without one, and the forward's kept weights are exactly pair_keep of
    the translated ids."""
    _, view = _shard(rng)
    tb = _tables(rng, view, 2, 4)
    ident = torch.arange(view.ext_size, dtype=torch.int32)
    for fn_list, call in ((bins.bin_gat_fwd_list_plain, _fwd),
                          (bins.bin_gat_bwd_list_plain, _bwd)):
        for a, b in zip(call(tb, view, fn_list, ident),
                        call(tb, view, fn_list, None)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    # one segment of the forward: its dropped weights by hand
    nbr, row, count = next(seg for seg in view.fwd.segs()
                           if bool((seg[2] > 1).any()))
    s = int(torch.nonzero(count > 1)[0])
    gid = view.ext_gids
    one = [(nbr[s:s + 1], row[s:s + 1], count[s:s + 1])]
    m, l, _, acc, _ = bins.bin_gat_fwd_list_plain(
        tb["feat"], tb["ac"], tb["ar"], one, slope=SLOPE, with_pos=True,
        p=P_DROP, seed=SEED, gid=gid)
    k = int(count[s])
    ids = nbr[s, :k].long()
    sr = tb["ar"][row[s].long()][None, :] + tb["ac"][ids]
    w = torch.exp(torch.where(sr >= 0, sr, SLOPE * sr) - m[0])
    keep = pair_keep(SEED, gid[row[s].long()], gid.long()[ids], 2, P_DROP)
    want = torch.einsum("wh,whf->hf", w * keep, tb["feat"][ids])
    torch.testing.assert_close(acc[0], want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(l[0], w.sum(0), rtol=1e-5, atol=1e-6)
    db = view.fwd.dense
    for a, b in zip(
            dense.dense_gat_fwd_plain(db, tb["ar"], tb["ac"], tb["feat"],
                                      slope=SLOPE, with_pos=True, p=P_DROP,
                                      seed=SEED, dense_dtype="float32",
                                      gid=ident),
            dense.dense_gat_fwd_plain(db, tb["ar"], tb["ac"], tb["feat"],
                                      slope=SLOPE, with_pos=True, p=P_DROP,
                                      seed=SEED, dense_dtype="float32")):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gid_changes_the_mask(rng):
    """A table that is not the identity moves the dropout mask (the shard's
    extended ids are not its global ids), so the sharded path cannot pass
    its comparison without the table."""
    _, view = _shard(rng)
    tb = _tables(rng, view, 2, 4)
    with_gid = _fwd(tb, view, bins.bin_gat_fwd_list_plain, view.ext_gids)
    without = _fwd(tb, view, bins.bin_gat_fwd_list_plain, None)
    assert not torch.allclose(with_gid[3], without[3])


def test_a_gid_table_on_another_device_is_refused(rng):
    _, view = _shard(rng)
    with pytest.raises(ValueError, match="gid"):
        bins._check_gid("bin_gat_fwd", view.ext_gids,
                        torch.empty(0, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,f", [(4, 64), (1, 7)])
def test_cuda_gid_kernels_match_plain(rng, cuda_device, h, f):
    """K1, K2 (every bin of a direction, one launch) and K5, K6 (the hub
    block) with the shard's gid table, p 0.3, against their plain versions
    on the same tensors; each launch counts under its ``_gid`` key."""
    _, view = _shard(rng)
    tb = {k: v.to(cuda_device) for k, v in _tables(rng, view, h, f).items()}
    view = view.to(cuda_device)
    gid = view.ext_gids
    before = dict(bins.LAUNCHES)
    got = _fwd(tb, view, bins.bin_gat_fwd_list, gid)
    want = _fwd(tb, view, bins.bin_gat_fwd_list_plain, gid)
    got_b = _bwd(tb, view, bins.bin_gat_bwd_list, gid)
    want_b = _bwd(tb, view, bins.bin_gat_bwd_list_plain, gid)
    torch.cuda.synchronize()
    for a, b in zip(got + got_b, want + want_b):
        torch.testing.assert_close(a, b, **TOL)
    assert bins.LAUNCHES["bin_gat_fwd_gid"] == before["bin_gat_fwd_gid"] + 1
    assert bins.LAUNCHES["bin_gat_bwd_gid"] == before["bin_gat_bwd_gid"] + 1
    assert bins.LAUNCHES["bin_gat_fwd"] == before["bin_gat_fwd"]
    for fn, db, args in (
            (dense.dense_gat_fwd, view.fwd.dense,
             (tb["ar"], tb["ac"], tb["feat"])),
            (dense.dense_gat_bwd, view.bwd.dense,
             (tb["g"], tb["ar"], tb["M"], tb["Linv"], tb["ws"], tb["ac"],
              tb["feat"]))):
        kw = dict(slope=SLOPE, p=P_DROP, seed=SEED, dense_dtype="float32",
                  gid=gid)
        if fn is dense.dense_gat_fwd:
            kw["with_pos"] = True
        plain = getattr(dense, fn.__name__ + "_plain")
        key = fn.__name__ + "_gid"
        n0 = dense.LAUNCHES[key]
        got = fn(db, *args, **kw)
        assert dense.LAUNCHES[key] == n0 + 1
        want = plain(db, *args, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if b is not None:
                torch.testing.assert_close(a, b, **TOL)
