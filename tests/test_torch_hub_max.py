"""The hub block's row maximum on a graph where one block column's score
tops every score of the rows that do not link to it by far more than
float32's exp range (exp(-104) is already zero): the port's GAT against
the benchmark's plain reference (gnnbench/reference/gat_reddit.py),
forward and training, on the CPU plain path; and, on a CUDA device, the
forward kernel K5 against its plain version on the same block.

The graph is the benchmark's R-MAT cut to 300 nodes, which keeps a hub
block under dense="auto".  The planted column is the block column most
rows link to; its node's features are set so that its projected features
are LIFT times the first layer's source attention vector, which lifts its
source coefficient (ac) by about LIFT * |attn_r|^2 a head, feature dropout
or not.  A block row's m used to be a bound, LeakyReLU(ar + max ac) over
every block column, so the rows that do not link to the column lost all
their weights to underflow and came out zero.

The card's tests run on a machine without JAX:  python -m pytest
--noconftest -m cuda tests/test_torch_hub_max.py
"""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import functools
import json
import types
from pathlib import Path

import pytest
import torch

from dgnn_tpu_torch.graph.build import csr_to_csc_permute
from dgnn_tpu_torch.graph.structure import build_graph_from_csr
from dgnn_tpu_torch.models import gat as gat_model
from dgnn_tpu_torch.ops import dense
from dgnn_tpu_torch.ops.gat import gat_aggregate
from gnnbench import check, graphs, harness
from gnnbench.reference.common import Edges, rounder

BENCH = Path(__file__).resolve().parents[1] / "gnnbench"
# the benchmark's tiny R-MAT; at least heads x hidden (256) input features,
# so that the planted node's projection can be any vector
NODES, DRAWS, FEATS, CLASSES = 300, 6000, 320, 5
SEED = 2 ** 31 + 77
LIFT = 100.0
# the planted column's least source coefficient over the rows' scores that
# do not reach it, and past which exp underflows in float32
GAP = 110.0
SLOPE = 0.2
# The reference against the port's plain path.  Forward: the largest
# readings over four seeds, in float32 (gathered rows and the hub block's
# products) and as the cell runs (both in bf16); the parent's bound zeroed
# the rows that miss the column, logit_rms_gap 0.5 or more.  Training is
# held in float32 alone: the planted column's softmax saturates on the rows
# that reach it, so its d ac is a difference of nearly equal terms, which
# bf16 storage of the gathered g rows and of the forward's ac column
# leaves to rounding (grad_gap 1.8e-3 to 0.2 over four seeds; 4.5 where
# the backward's M column was rounded too); in float32 loss1_gap read 0
# and grad_gap at most 5.2e-4.
# (float32: logit_gap at most 7.9e-7, bf16: 6.1e-4; logit_rms_gap 8.1e-8,
# 8.8e-5)
LIMITS = {"float32": dict(logit_gap=1e-4, logit_rms_gap=1e-5),
          "bfloat16": dict(logit_gap=5e-3, logit_rms_gap=1e-3)}
TRAIN_LIMITS = dict(loss1_gap=1e-5, grad_gap=5e-3)


@pytest.fixture
def exact_block(monkeypatch):
    """The model's hub block with its products in float32."""
    monkeypatch.setattr(gat_model, "gat_aggregate",
                        functools.partial(gat_aggregate,
                                          dense_dtype="float32"))


def planted_cell(seed=SEED, rows="bfloat16"):
    """(cell, graph data, the port's host graph, inputs, planted node):
    configuration ``gat_reddit`` (the cell ``gat.reddit.train``'s) as the
    benchmark states it, in training with
    gathered rows stored as ``rows``, over the tiny R-MAT, its inputs from
    ``seed`` with the planted node's features set."""
    src, dst = graphs.rmat_edges(NODES, DRAWS, 0)
    row_ptr, col_ind = graphs.simple_csr(src, dst, NODES)
    data = graphs.GraphData(row_ptr, col_ind, FEATS, CLASSES, "", {})
    host = build_graph_from_csr(row_ptr, col_ind,
                                *csr_to_csc_permute(row_ptr, col_ind),
                                dense="auto", edge_tables=False)
    cell = types.SimpleNamespace(
        cfg=json.loads((BENCH / "configs" / "gat_reddit.json").read_text()),
        cfg_mod=harness.load_module(BENCH / "configs" / "gat_reddit.py",
                                    "hub_max_config_gat_reddit"),
        ref=harness.load_module(BENCH / "reference" / "gat_reddit.py",
                                "hub_max_reference_gat_reddit"),
        traffic=dict(mode="train", gather_dtype=rows, n_classes=CLASSES))
    inputs = harness.make_inputs(cell, data, seed, torch.device("cpu"))
    node = top_column(host.fwd.dense)
    w = inputs.weights
    a = w["gat_0.attn_r"].reshape(-1)
    inputs.feats[node] = torch.linalg.lstsq(
        w["gat_0.W"], LIFT * a[:, None]).solution[:, 0]
    return cell, data, host, inputs, node


def top_column(db):
    """The node of the block column that the most block rows link to."""
    cols = torch.cat([c for _, c in dense._tiles(db)])
    ids, counts = db.col_ids.long()[cols].unique(return_counts=True)
    return int(ids[counts.argmax()])


def leaky(s):
    return torch.where(s >= 0, s, SLOPE * s)


def block_tables(seed=SEED):
    """The planted block and first-layer tables of its forward: ar, ac and
    the projected features of every node, from the planted inputs, with
    no dropout; returns (block, ar, ac, feat, the real block rows that do
    not link to the planted node, the planted node)."""
    _, _, host, inputs, node = planted_cell(seed)
    w = inputs.weights
    h, f = 4, 64
    x = (inputs.feats @ w["gat_0.W"].T).reshape(-1, h, f)
    ar = (w["gat_0.attn_l"] * x).sum(-1)
    ac = (w["gat_0.attn_r"] * x).sum(-1)
    db = host.fwd.dense
    rows, cols = map(torch.cat, zip(*dense._tiles(db)))
    hit = rows[db.col_ids.long()[cols] == node].unique()
    miss = torch.ones(db.row_ids.shape[0], dtype=torch.bool)
    miss[hit] = False
    miss[db.num_rows:] = False
    return db, ar, ac, x, miss, node


def test_the_plant_tops_the_rows_that_miss_it():
    """Every score of a row that does not link to the planted node lies
    more than GAP below what the row's bound would be: the case the
    underflow hid."""
    db, ar, ac, x, miss, node = block_tables()
    rows, cols = map(torch.cat, zip(*dense._tiles(db)))
    keep = miss[rows]
    rid = db.row_ids.long()[rows[keep]]
    s = leaky(ar[rid] + ac[db.col_ids.long()[cols[keep]]])
    top = torch.full((db.row_ids.shape[0], 4), -1e30).scatter_reduce(
        0, rows[keep][:, None].expand(-1, 4), s, "amax")
    bound = leaky(ar[db.row_ids.long()] + ac[node])
    assert int(miss.sum()) >= 50
    assert ((bound - top)[miss] > GAP).all()


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_forward_matches_the_reference(precision, request):
    """The port's model in training (feature dropout from one generator)
    against the reference's forward from the same draws, in float32 and
    in the cell's bf16: the logits agree, and no row is zero where the
    reference's is not (a node whose neighbours' output features all
    drop out has zero logits on both sides; this seed has none)."""
    if precision == "float32":
        request.getfixturevalue("exact_block")
    cell, data, host, inputs, _ = planted_cell(rows=precision)
    prog = cell.cfg_mod.Program(cell.cfg, cell.traffic, host, inputs.feats,
                                inputs.labels, inputs.weights,
                                inputs.drop_seed, torch.device("cpu"))
    prog.model.train()
    gen = torch.Generator().manual_seed(inputs.drop_seed)
    with torch.no_grad():
        got = prog.logits(gen)
    edges = Edges(data.row_ptr, data.col_ind, "cpu")
    gen = torch.Generator().manual_seed(inputs.drop_seed)
    with torch.no_grad():
        want = cell.ref.forward(cell.cfg, inputs.weights, inputs.feats,
                                edges, CLASSES, generator=gen,
                                q=rounder(precision))
    zero = got.abs().sum(dim=1) == 0
    assert not (zero & (want.abs().sum(dim=1) > 0)).any()
    assert not zero.any()
    nums = check.inference_numbers([got], want)
    for k, v in LIMITS[precision].items():
        assert nums[k] <= v, nums


def test_training_matches_the_reference(exact_block):
    """The benchmark's first captured steps (the CPU loop) against the
    reference's, in float32: the first loss and the first gradients as
    Adam took them."""
    cell, data, host, inputs, _ = planted_cell(rows="float32")
    _, rep, first = harness.start(cell, inputs, host, torch.device("cpu"),
                                  warm=False)
    rep.close()
    edges = Edges(data.row_ptr, data.col_ind, "cpu")
    nums = harness.numbers(cell, inputs, first,
                           harness.reference_side(cell, data, inputs, edges))
    for k, v in TRAIN_LIMITS.items():
        assert nums[k] <= v, nums


def test_plain_rows_are_exact_maxima():
    """K5's plain version: m is each row's largest score, -1e30 where a row
    has no edge, and every row with an edge keeps a positive l."""
    db, ar, ac, x, miss, _ = block_tables()
    for dt in dense.DENSE_DTYPES:
        m, l, _, acc, _ = dense.dense_gat_fwd_plain(
            db, ar, ac, x, slope=SLOPE, with_pos=False, dense_dtype=dt)
        rows, cols = map(torch.cat, zip(*dense._tiles(db)))
        s = leaky(ar[db.row_ids.long()[rows]] + ac[db.col_ids.long()[cols]])
        want = torch.full_like(m, -1e30).scatter_reduce(
            0, rows[:, None].expand(-1, 4), s, "amax")
        assert torch.equal(m, want)
        has = torch.zeros(m.shape[0], dtype=torch.bool)
        has[rows] = True
        assert (l[has] > 0).all() and not l[~has].any()
        assert (m[~has] == -1e30).all()


def test_bound_gap_is_the_kernels():
    """K5 keeps the gap as a constant of its own (csrc/dense_gat.cu
    kBoundGap); the plain version reads ops/dense.py BOUND_GAP."""
    import re

    src = (Path(dense.__file__).resolve().parents[1] / "csrc"
           / "dense_gat.cu").read_text()
    got = re.findall(r"constexpr float kBoundGap = ([0-9.]+)f;", src)
    assert [float(v) for v in got] == [dense.BOUND_GAP]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dense_dtype", dense.DENSE_DTYPES)
@pytest.mark.parametrize("p", [0.0, 0.3])
def test_cuda_fwd_matches_plain_on_the_planted_block(cuda_device,
                                                    dense_dtype, p):
    """K5 against its plain version on the planted block: the same m,
    bit for bit, and partials within float32 summation order."""
    db, ar, ac, x, miss, _ = block_tables()
    db = db.to(cuda_device)
    ar, ac, x = (t.to(cuda_device) for t in (ar, ac, x))
    kw = dict(slope=SLOPE, with_pos=True, p=p, seed=SEED,
              dense_dtype=dense_dtype)
    got = dense.dense_gat_fwd(db, ar, ac, x, **kw)
    want = dense.dense_gat_fwd_plain(db, ar, ac, x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    assert (got[1][miss.to(cuda_device)] > 0).all()
