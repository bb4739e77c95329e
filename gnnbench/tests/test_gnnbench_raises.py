"""The reader of the hub block forward's second walks
(``max_raise_pct.train``): a number from a recording of K5's counts,
nothing from an empty recorder, from launches without counts or from a
port that keeps none."""

import types

import pytest
import torch

import gnnbench_cells
from gnnbench.harness import load_module
from dgnn_tpu_torch.utils import profiling

METRIC = "max_raise_pct.train"
CTX = types.SimpleNamespace(e2e={"train_ms": 190.0})


def reader():
    return load_module(gnnbench_cells.FOLDER / "metrics" / f"{METRIC}.py",
                       f"gnnbench_metric_{METRIC}")


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the port's place."""
    fresh = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", fresh)
    return fresh


def _launch(name, raises=None, edges=None, rows=8):
    """A probed launch over ``rows`` block rows: K5's buffer holds its
    stamps, then each row's raises and edges; the others' the stamps."""
    buf = torch.zeros((rows, 2 if raises is None else 4), dtype=torch.int64)
    buf[:, 1] = 1_000
    if raises is not None:
        buf[:, 2] = torch.as_tensor(raises)
        buf[:, 3] = torch.as_tensor(edges)
    return profiling._Launch(name, rows, buf)


def test_a_recording_gives_its_number(rec):
    """Both K5 launches of a step count; K6's and K7's have no counts."""
    rec.replayed((
        _launch("dense_gat_fwd_kernel<4, 8>", [3] * 8, [100] * 8),
        _launch("dense_gat_bwd_kernel<4, 8>"),
        _launch("dense_gat_fwd_kernel<4, 2>", [1] * 4 + [0] * 4,
                [50] * 4 + [0] * 4),
        _launch("dense_gmm_fwd_kernel<model, 8>")))
    assert reader().read(CTX) == pytest.approx(100 * 28 / 1000, rel=1e-12)
    spans = dict(profiling.row_spans())
    assert spans["dense_gat_fwd_kernel<4, 8>"].shape == (8, 2)


def test_an_empty_recorder_gives_nothing(rec):
    assert reader().read(CTX) is None


def test_launches_without_counts_give_nothing(rec):
    rec.replayed((_launch("dense_gat_bwd_kernel<4, 8>"),
                  _launch("dense_gat_fwd_kernel<4, 8>", [0] * 8, [0] * 8)))
    assert reader().read(CTX) is None


def test_a_port_without_the_counts_gives_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "row_raises")
    assert reader().read(CTX) is None
