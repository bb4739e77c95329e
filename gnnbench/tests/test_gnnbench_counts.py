"""Operations and bytes counted from the graph's size and the widths,
against hand counts at a tiny size, and against the matrix products the
reference really runs."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import gnnbench_cells  # noqa: F401
from gnnbench import graphs, peaks
from gnnbench.harness import init_weights, load_module
from gnnbench.reference import gat as rgat
from gnnbench.reference import monet as rmonet
from gnnbench.reference.common import Edges

CONFIGS = gnnbench_cells.FOLDER / "configs"
GAT = load_module(CONFIGS / "gat.py", "gnnbench_config_gat")
MONET = load_module(CONFIGS / "monet.py", "gnnbench_config_monet")
GAT_CFG = dict(num_layers=1, heads=[2, 1], n_hidden=3, feat_drop=0.0,
               negative_slope=0.2)
MONET_CFG = dict(n_layers=1, n_hidden=3, n_kernels=2, dim=2, dropout=0.0)


def test_gat_by_hand():
    # N = 4, E = 10, 5 features, 2 classes, float32 rows
    assert GAT.mp_passes(GAT_CFG, 4, 10, 5, 2, 4, "train") == [
        (264, 336), (108, 176), (120, 240), (320, 496)]
    assert GAT.mp_passes(GAT_CFG, 4, 10, 5, 2, 4, "infer") == [
        (264, 336), (108, 176)]
    assert GAT.model_flops(GAT_CFG, 4, 10, 5, 2, "train") == 1964


def test_monet_by_hand():
    # N = 4, E = 10, 5 features, 2 classes, bf16 rows
    assert MONET.mp_passes(MONET_CFG, 4, 10, 5, 2, 2, "infer") == [
        (420, 240), (380, 192)]
    assert MONET.model_flops(MONET_CFG, 4, 10, 5, 2, "infer") == 1136


def test_least_time_takes_the_larger_bound():
    pk = dict(hbm_bytes_per_s=1.0, float32_flops=2.0)
    assert peaks.least_seconds([(10, 3), (2, 7)], pk) == 5 + 7


def _products(cfg, mod, ref, in_feats=5, n_classes=2, train=True):
    """The matrix products' operations of one reference step, by torch's
    own flop counter."""
    src, dst = graphs.rmat_edges(60, 500, 0)
    rp, ci = graphs.simple_csr(src, dst, 60)
    edges = Edges(rp, ci, "cpu")
    gen = torch.Generator().manual_seed(0)
    w = init_weights(mod.leaves(cfg, in_feats, n_classes), gen, "cpu")
    w = {k: v.requires_grad_(True) for k, v in w.items()}
    feats = torch.randn(60, in_feats, generator=gen)
    with FlopCounterMode(display=False) as fc:
        out = ref.forward(cfg, w, feats, edges, n_classes)
        if train:
            out.square().sum().backward()
    return fc.get_total_flops(), 60, edges.num_edges


@pytest.mark.parametrize("train", [True, False])
def test_gat_projections_are_what_runs(train):
    mode = "train" if train else "infer"
    got, n, e = _products(GAT_CFG, GAT, rgat, train=train)
    counted = GAT.model_flops(GAT_CFG, n, e, 5, 2, mode) - sum(
        f for f, _ in GAT.mp_passes(GAT_CFG, n, e, 5, 2, 4, mode))
    cols = sum(2 * 2 * n * h * f * (3 if train else 1)
               for _, _, h, f, _ in GAT.layer_dims(GAT_CFG, 5, 2))
    assert counted - cols == got


@pytest.mark.parametrize("train", [True, False])
def test_monet_projections_are_what_runs(train):
    mode = "train" if train else "infer"
    got, n, e = _products(MONET_CFG, MONET, rmonet, train=train)
    counted = MONET.model_flops(MONET_CFG, n, e, 5, 2, mode) - sum(
        f for f, _ in MONET.mp_passes(MONET_CFG, n, e, 5, 2, 4, mode))
    # the reference projects each edge's two pseudo scalars by a matrix
    # product too ([E, 2] x [2, D], two layers), counted there under
    # message passing; in training its checkpointed blocks run it again
    # before the product of its gradient
    pseudo = 2 * e * 2 * MONET_CFG["dim"] * 2 * (3 if train else 1)
    assert counted + pseudo == got


@pytest.mark.parametrize("mod,cfg", [(GAT, GAT_CFG), (MONET, MONET_CFG)])
def test_a_share_of_the_peak_stays_under_100(mod, cfg):
    # the least time of a step can never exceed the model's operations at
    # the peak rate plus its bytes at the peak bandwidth
    pk = peaks.PEAKS["NVIDIA H100 80GB HBM3"]
    for mode in ("train", "infer"):
        passes = mod.mp_passes(cfg, 232965, 79271606, 602, 41, 2, mode)
        least = peaks.least_seconds(passes, pk)
        flops = mod.model_flops(cfg, 232965, 79271606, 602, 41, mode)
        assert least <= flops / pk["float32_flops"] + sum(
            b for _, b in passes) / pk["hbm_bytes_per_s"]
