"""The per-layer readers of the port's recorder (row spans, host spans,
the replay series): a number from a recording, nothing from an empty
recorder or from a port that has none, and the set-up metrics within a
CPU run's set-up."""

import time
import types

import numpy as np
import pytest
import torch

import gnnbench_cells
from gnnbench.harness import load_module
from dgnn_tpu_torch.utils import profiling

FOLDER = gnnbench_cells.FOLDER
NEW = ("hub_tail_pct.train", "hub_tail_pct.infer", "setup_graph_s",
       "setup_capture_s", "slow_pct.citation")
CTX = types.SimpleNamespace(e2e={"setup_s": 20.0})


def reader(metric):
    return load_module(FOLDER / "metrics" / f"{metric}.py",
                       f"gnnbench_metric_{metric}")


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the port's place."""
    fresh = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", fresh)
    return fresh


class _Series:
    def __init__(self, points):
        self._points = points

    def points(self):
        return self._points


def _launch(name, ends_ns):
    rows = torch.zeros((len(ends_ns), 2), dtype=torch.int64)
    rows[:, 0] = 1_000
    rows[:, 1] = 1_000 + torch.as_tensor(ends_ns)
    return profiling._Launch(name, len(ends_ns), rows)


def _record(rec):
    """A recording as a traced run of a cell leaves it."""
    for name, parent in (("dgnn.graph.cache.load", None),
                         ("dgnn.graph.to", None),
                         ("dgnn.stepgraph.warmup", None),
                         ("dgnn.kernels.load", "dgnn.stepgraph.warmup"),
                         ("dgnn.stepgraph.capture", None),
                         ("dgnn.stepgraph.replay", None)):
        s = rec.span(name)
        s.parent, s.start_ns, s.end_ns = parent, 0, 2_000_000_000
        rec._close(s)
    long_row = [10_000] * 99 + [1_000_000]
    rec.replayed((_launch("dense_gmm_fwd_kernel<model, 8>", long_row),
                  _launch("dense_gmm_bwd_kernel<model, 8>", [500] * 100),
                  _launch("dense_gat_fwd_kernel<4, 8>", [1_000] * 100)))
    pts, t, c = [(0.0, 0, False)], 0.0, 0
    for ms in [1.756] * 100 + [1.641] * 200:
        t, c = t + 29 * ms, c + 29
        pts.append((t, c, False))
    rec.series = _Series(pts)


@pytest.mark.parametrize("metric", NEW)
def test_an_empty_recorder_gives_nothing(rec, metric):
    assert reader(metric).read(CTX) is None


@pytest.mark.parametrize("metric", NEW)
def test_a_port_without_a_recorder_gives_nothing(monkeypatch, metric):
    for name in ("row_spans", "tail_pct", "totals", "replay_points",
                 "slow_share"):
        monkeypatch.delattr(profiling, name)
    assert reader(metric).read(CTX) is None


@pytest.mark.parametrize("metric,want", [
    ("hub_tail_pct.train", 100 * 990_000 / 1_001_500),
    ("hub_tail_pct.infer", 0.0),
    ("setup_graph_s", 4.0),
    ("setup_capture_s", 4.0),
    ("slow_pct.citation", 100 * 99 / 299)])
def test_a_recording_gives_its_number(rec, metric, want):
    _record(rec)
    assert reader(metric).read(CTX) == pytest.approx(want, rel=1e-9)


def test_the_set_up_metrics_lie_within_set_up(tmp_path, rec):
    """A cell on the CPU: the port's graph is built and saved, then copied
    (no StepGraph there, so no capture's seconds)."""
    bench = gnnbench_cells.tiny_bench(tmp_path)
    t0 = time.time()
    r = gnnbench_cells.run(bench, "monet.reddit.train")
    graph_s = reader("setup_graph_s").read(CTX)
    assert 0 < graph_s <= r["metrics"]["setup_s"]["value"]
    assert graph_s <= time.time() - t0
    roots = profiling.totals(roots=True)
    assert {"dgnn.graph.csc", "dgnn.graph.build", "dgnn.graph.cache.save",
            "dgnn.graph.to"} <= set(roots)
    assert reader("setup_capture_s").read(CTX) is None
    assert np.isfinite(graph_s)
