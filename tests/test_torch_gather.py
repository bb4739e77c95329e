"""The two gather study kernels of the port (dgnn_tpu_torch/ops/gather.py):
their plain versions against numpy on the CPU, the wrappers' checks, the
study script at a small size, and, on a CUDA device, the kernels against
their plain versions.

The JAX counterparts (scripts/microbench_gather.py) are TPU-only Pallas
kernels fixed at the study's shapes, so numpy states the two functions
here.  The CUDA tests run on a machine without JAX:
python -m pytest --noconftest -m cuda tests/test_torch_gather.py
"""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from dgnn_tpu_torch.ops import gather


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _study():
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" \
        / "microbench_gather_torch.py"
    spec = importlib.util.spec_from_file_location("microbench_gather_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(rng, n, shape, s, w):
    feat = rng.normal(size=(n,) + shape).astype(np.float32)
    nbr = rng.integers(0, n, (s, w)).astype(np.int32)
    return feat, nbr


def _lanes(rng, c, lanes, groups, r):
    tab = rng.normal(size=(c, lanes * groups)).astype(np.float32)
    idx = rng.integers(0, c, (r, lanes)).astype(np.int32)
    return tab, idx


def _np_lanes(tab, idx):
    """out[r, k * L + l] = tab[idx[r, l], k * L + l], written out."""
    lanes = idx.shape[1]
    out = np.empty((idx.shape[0], tab.shape[1]), np.float32)
    for k in range(tab.shape[1] // lanes):
        cols = np.arange(k * lanes, (k + 1) * lanes)
        out[:, cols] = tab[idx, cols[None, :]]
    return out


@pytest.mark.parametrize("shape,w", [((8, 128), 32), ((2, 128), 64),
                                     ((12,), 5), ((3, 4), 1),
                                     ((1300, 4), 7), ((9, 4), 40),
                                     ((32,), 33)],
                         ids=["sub8-w32", "sub2-w64", "flat-w5", "w1",
                              "ragged-last-slice", "one-group-past-a-slice",
                              "one-slice-w33"])
def test_gather_rows_sum_plain_matches_numpy(rng, shape, w):
    feat, nbr = _rows(rng, 50, shape, 7, w)
    want = feat[nbr].astype(np.float64).sum(axis=1)
    for fn in (gather.gather_rows_sum, gather.gather_rows_sum_plain):
        got = fn(torch.from_numpy(feat), torch.from_numpy(nbr))
        assert got.dtype == torch.float32 and tuple(got.shape) == (7,) + shape
        # float32 sums of w terms against a float64 sum
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=w * 2.0 ** -22)
    assert gather.LAUNCHES == dict.fromkeys(gather.LAUNCHES, 0)


def test_gather_rows_sum_repeated_ids(rng):
    feat, nbr = _rows(rng, 9, (4,), 3, 6)
    nbr[1] = 2                                  # one row six times
    got = gather.gather_rows_sum(torch.from_numpy(feat), torch.from_numpy(nbr))
    np.testing.assert_allclose(got[1].numpy(), 6 * feat[2], rtol=1e-6)


@pytest.mark.parametrize("c,lanes,groups", [(16, 128, 2), (5, 8, 3),
                                            (7, 4, 1)],
                         ids=["study", "three-groups", "one-group"])
def test_gather_lanes_plain_matches_numpy(rng, c, lanes, groups):
    tab, idx = _lanes(rng, c, lanes, groups, 11)
    want = _np_lanes(tab, idx)
    for fn in (gather.gather_lanes, gather.gather_lanes_plain):
        got = fn(torch.from_numpy(tab), torch.from_numpy(idx))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    # and it is what torch.gather gives on the widened index
    wide = torch.from_numpy(idx).repeat(1, groups).long()
    assert torch.equal(torch.gather(torch.from_numpy(tab), 0, wide),
                       torch.from_numpy(want))
    assert gather.LAUNCHES == dict.fromkeys(gather.LAUNCHES, 0)


@pytest.mark.parametrize("c,want", [(512, 32), (1024, 32), (2048, 16),
                                    (4096, 8), (51200, 1), (51201, 0)])
def test_lane_slab_width_fits_shared_memory(c, want):
    w = gather.lane_slab_width(c, 256)
    assert w == want
    assert c * w * 4 <= gather.LANE_SLAB_BYTES
    if 0 < w < 32:  # the next wider slab would not fit
        assert c * 2 * w * 4 > gather.LANE_SLAB_BYTES


def test_lane_slab_width_stays_inside_the_table():
    """At most a warp's 32 banks wide, and never twice the table's width:
    the last slab may overhang a width that is no multiple of it."""
    assert gather.lane_slab_width(4, 8) == 8
    assert gather.lane_slab_width(4, 256) == 32
    assert gather.lane_slab_width(4, 18) == 32      # one slab, 14 columns over
    assert gather.lane_slab_width(4, 3) == 4
    assert gather.lane_slab_width(4, 1) == 1


def test_gather_wrappers_refuse_bad_shapes(rng):
    feat, nbr = _rows(rng, 9, (4,), 3, 6)
    f, n = torch.from_numpy(feat), torch.from_numpy(nbr)
    with pytest.raises(ValueError):
        gather.gather_rows_sum(f[:, 0], n)          # a table without rows
    with pytest.raises(ValueError):
        gather.gather_rows_sum(f, n[0])             # ids not [S, W]
    with pytest.raises(ValueError):
        gather.gather_rows_sum(f[:0], n)            # an empty table
    tab, idx = _lanes(rng, 5, 8, 2, 4)
    t, i = torch.from_numpy(tab), torch.from_numpy(idx)
    with pytest.raises(ValueError):
        gather.gather_lanes(t[:, :12], i)           # 12 is no multiple of 8
    with pytest.raises(ValueError):
        gather.gather_lanes(t[0], i)


@pytest.mark.parametrize("bad", [-1, 9])
def test_gather_plain_refuses_ids_outside_the_table(rng, bad):
    feat, nbr = _rows(rng, 9, (4,), 3, 6)
    nbr[2, 5] = bad if bad > 0 else -10         # -1 would wrap around
    with pytest.raises(IndexError):
        gather.gather_rows_sum(torch.from_numpy(feat), torch.from_numpy(nbr))
    tab, idx = _lanes(rng, 9, 8, 2, 4)
    idx[3, 7] = bad if bad > 0 else -10
    with pytest.raises(IndexError):
        gather.gather_lanes(torch.from_numpy(tab), torch.from_numpy(idx))


def test_gather_study_runs_on_cpu():
    """The study script end to end at 1/256 of its sizes: every case, the
    plain versions and the library calls agreeing, no kernel launched."""
    mod = _study()
    gather.reset_launches()
    cases = mod.study("cpu", iters=1, scale=256)
    kinds = [c["case"]["kind"] for c in cases]
    assert kinds == ["index"] + ["rows"] * len(mod.ROWS_CASES) \
        + ["lanes"] * len(mod.LANES_CASES)
    for case in cases:
        names = [r["variant"] for r in case["rows"]]
        assert not any(n.startswith("kernel") for n in names)
        assert all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in case["rows"])
    assert [c["case"]["W"] for c in cases[1:5]] == [32, 64, 256, 64]
    assert gather.LAUNCHES == dict.fromkeys(gather.LAUNCHES, 0)


def _variants():
    scripts = pathlib.Path(__file__).resolve().parents[1] / "scripts"
    sys.path.insert(0, str(scripts))
    try:
        import gather_variants_torch
    finally:
        sys.path.remove(str(scripts))
    return gather_variants_torch


@pytest.mark.parametrize("name", ["as built", "slices of 64",
                                  "slices of 128", "unroll 4",
                                  "slices of 128, unroll 4",
                                  "evict_last hint",
                                  "unroll 4, evict_last hint"])
def test_gather_variants_edit_lines_of_this_checkout(tmp_path, name):
    """Each variant of scripts/gather_variants_torch.py rewrites lines that
    stand exactly once in the kernel's source, and its copy differs from
    the source by just those lines."""
    mod = _variants()
    edits = mod.VARIANTS[name]
    tree = mod.make_tree(str(tmp_path), name, edits)
    src = pathlib.Path(mod.ROOT) / "dgnn_tpu_torch" / "csrc" / "gather.cu"
    got = (pathlib.Path(tree) / "dgnn_tpu_torch" / "csrc"
           / "gather.cu").read_text()
    want = src.read_text()
    for path, old, new in edits:
        assert path == "csrc/gather.cu" and want.count(old) == 1
        want = want.replace(old, new)
    assert got == want


def test_gather_study_library_calls_compute_the_same_function(rng):
    mod = _study()
    feat, nbr = _rows(rng, 40, (2, 128), 6, 9)
    f, n = torch.from_numpy(feat), torch.from_numpy(nbr)
    torch.testing.assert_close(
        mod.rows_library(f, n.long()).view(6, 2, 128),
        gather.gather_rows_sum_plain(f, n), **mod.rows_tol(9))
    tab, idx = _lanes(rng, 12, 128, 2, 5)
    t, i = torch.from_numpy(tab), torch.from_numpy(idx)
    assert torch.equal(mod.lanes_library(t, i.repeat(1, 2).long()),
                       gather.gather_lanes_plain(t, i))


# ---------------------------------------------------------------------------
# on a CUDA device: the kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n,shape,s,w,span", [
    (300, (8, 128), 20, 32, 300), (300, (2, 128), 9, 64, 300),
    (300, (8, 128), 3, 256, 300), (300, (12,), 17, 5, 300),
    (300, (1300, 4), 2, 3, 300),
    # large tables in many column slices of 32 floats: 5200 floats a row
    # (the last slice 16), 128, and 36 (the last slice one 16-byte group)
    (4096, (1300, 4), 40, 7, 4096), (100000, (128,), 33, 40, 100000),
    (50000, (9, 4), 21, 70, 50000),
    # every segment names the same five rows again and again
    (300, (8, 128), 50, 64, 5)],
    ids=["sub8-w32", "sub2-w64", "sub8-w256", "flat-w5", "two-column-slabs",
         "multi-slice-ragged", "many-slices", "one-group-past-a-slice",
         "repeats-across-segments"])
def test_cuda_gather_rows_sum_matches_plain(rng, cuda_device, n, shape, s, w,
                                            span):
    feat, nbr = _rows(rng, n, shape, s, w)
    nbr %= span
    f = torch.from_numpy(feat).to(cuda_device)
    n = torch.from_numpy(nbr).to(cuda_device)
    gather.reset_launches()
    got = gather.gather_rows_sum(f, n)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["gather_rows_sum"] == 1
    torch.testing.assert_close(got, gather.gather_rows_sum_plain(f, n),
                               rtol=1e-5, atol=w * 2.0 ** -22)


@pytest.mark.cuda
@pytest.mark.parametrize("c,lanes,groups", [
    (7, 128, 2), (512, 128, 2), (1024, 128, 2), (2048, 128, 2),
    (4096, 128, 2),
    (300, 6, 3),      # L no multiple of 4; width 18: one overhanging slab
    (300, 8, 3),      # width 24 is no multiple of the slab's 32 columns
    (3000, 10, 5),    # width 50 over slabs of 16: the last one overhangs
    (300, 1, 5),      # one id a row
    (51200, 8, 1)],   # a slab of one column
    ids=["c7", "c512", "c1024", "c2048", "c4096", "lanes6", "width24",
         "width50", "lanes1", "slab1"])
def test_cuda_gather_lanes_matches_plain(rng, cuda_device, c, lanes, groups):
    tab, idx = _lanes(rng, c, lanes, groups, min(3 * c + 1, 6145))
    t = torch.from_numpy(tab).to(cuda_device)
    i = torch.from_numpy(idx).to(cuda_device)
    gather.reset_launches()
    got = gather.gather_lanes(t, i)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["gather_lanes"] == 1
    assert torch.equal(got, gather.gather_lanes_plain(t, i))


@pytest.mark.cuda
def test_cuda_gather_refuses_what_the_kernels_do_not_take(rng, cuda_device):
    feat, nbr = _rows(rng, 9, (6,), 3, 4)       # rows of 6 floats
    f = torch.from_numpy(feat).to(cuda_device)
    n = torch.from_numpy(nbr).to(cuda_device)
    with pytest.raises(ValueError):
        gather.gather_rows_sum(f, n)
    with pytest.raises(TypeError):
        gather.gather_rows_sum(f[:, :4].contiguous(), n.long())
    with pytest.raises(ValueError):
        gather.gather_rows_sum(f.cpu(), n)      # mixed devices
    tab, idx = _lanes(rng, 60000, 8, 1, 4)      # no column of it fits
    with pytest.raises(ValueError):
        gather.gather_lanes(torch.from_numpy(tab).to(cuda_device),
                            torch.from_numpy(idx).to(cuda_device))


_TRAP = """
import sys, torch
from dgnn_tpu_torch.ops import gather
dev = torch.device("cuda")
ids = torch.zeros((4, 8), dtype=torch.int32, device=dev)
ids[2, 3] = int(sys.argv[2])
if sys.argv[1] == "rows":
    gather.gather_rows_sum(torch.ones((16, 8), device=dev), ids)
else:
    gather.gather_lanes(torch.ones((16, 16), device=dev), ids)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("trapped:", str(e).splitlines()[0])
    sys.exit(7)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rows", "lanes"])
@pytest.mark.parametrize("bad", [-1, 16])
def test_cuda_gather_traps_ids_outside_the_table(cuda_device, kernel, bad):
    """An id outside the table fails the launch instead of reading outside
    the table.  In a process of its own: the trap ends its CUDA context."""
    root = pathlib.Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", _TRAP, kernel, str(bad)],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert run.returncode == 7 and "trapped" in run.stdout, \
        (run.returncode, run.stdout, run.stderr[-2000:])
