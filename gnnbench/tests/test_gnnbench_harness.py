"""The harness driven by data: a configuration, a traffic mix and a
per-layer metric that a later change adds as new files are found by
name; and a run with the timed path broken underneath comes out not
correct, once for each fault a cell can have."""

import json
import shutil
import types

import pytest
import torch

import gnnbench_cells
from gnnbench.program import Program

FOLDER = gnnbench_cells.FOLDER


@pytest.fixture
def dummy_bench(tmp_path):
    """A configuration "dummy", a traffic "tiny.train" and a metric
    "dummy_ms.train" in new files of a temporary folder, and a cell of
    them."""
    cell = dict(name="dummy.tiny.train", config="dummy",
                traffic="tiny.train", chips=1, why="a later change's cell")
    bench = gnnbench_cells.tiny_bench(tmp_path, extra_cells=[cell])
    shutil.copy(FOLDER / "configs" / "monet.json",
                tmp_path / "configs" / "dummy.json")
    shutil.copy(FOLDER / "configs" / "monet.py",
                tmp_path / "configs" / "dummy.py")
    shutil.copy(FOLDER / "reference" / "monet.py",
                tmp_path / "reference" / "dummy.py")
    t = json.loads((FOLDER / "traffic" / "reddit.train.json").read_text())
    t.pop("num_edges")
    t.update(gnnbench_cells.TINY["rmat"], n_feats=16, n_classes=3)
    (tmp_path / "traffic" / "tiny.train.json").write_text(json.dumps(t))
    (tmp_path / "limits" / "dummy.tiny.train.json").write_text(
        (FOLDER / "limits" / "monet.reddit.train.json").read_text())
    (tmp_path / "metrics" / "dummy_ms.train.py").write_text(
        "def read(ctx):\n    return 1e3 * ctx.trace.busy_s / "
        "ctx.trace.steps\n")
    bench.spec["configs"].append(dict(
        name="dummy", source="https://example.org/dummy",
        file=str(tmp_path / "configs" / "dummy.json"), reduced=[],
        why="a later change's configuration"))
    bench.spec["per_layer"].append(dict(
        name="dummy_ms.train", unit="ms", better="lower",
        source="device_trace", layer="device", moves="train_ms",
        workloads=[cell["name"]]))
    return bench


def test_a_new_cell_is_found_by_name(dummy_bench):
    c = dummy_bench.cell("dummy.tiny.train")
    assert c.traffic["n_classes"] == 3
    assert [m["name"] for m in c.per_layer] == ["dummy_ms.train"]
    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(busy_s=0.5,
                                                            steps=2))
    assert c.readers["dummy_ms.train"].read(ctx) == 250.0
    r = gnnbench_cells.run(dummy_bench, "dummy.tiny.train")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"peak_mb", "setup_s"}
    assert list(r)[-1] == "checks"


def test_metrics_without_workloads_follow_what_they_move(dummy_bench):
    dummy_bench.spec["per_layer"][-1].pop("workloads")
    names = [m["name"] for m in dummy_bench.cell("gat.pubmed.train")
             .per_layer]
    assert "dummy_ms.train" not in names
    assert "dummy_ms.train" in [m["name"] for m in dummy_bench.cell(
        "monet.reddit.train").per_layer]


def _no_update(self):
    pass


def _half_batch(self, logits):
    keep = logits.shape[0] // 2
    return torch.nn.functional.cross_entropy(logits[:keep],
                                             self.labels[:keep])


_INFER = Program.infer


def _altered(self):
    _INFER(self)
    self.out[0, 0] += 1.0


def _half_answer(self):
    _INFER(self)
    self.out[self.out.shape[0] // 2:] = 0.0


TRAIN = [w["name"] for w in gnnbench_cells.SPEC["workloads"]
         if w["traffic"].endswith(".train")]
INFER = [w["name"] for w in gnnbench_cells.SPEC["workloads"]
         if w["traffic"].endswith(".infer")]
FAULTS = ([(c, "update", _no_update) for c in TRAIN]
          + [(c, "loss_of", _half_batch) for c in TRAIN]
          + [(c, "infer", _altered) for c in INFER]
          + [(c, "infer", _half_answer) for c in INFER])


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return gnnbench_cells.tiny_bench(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell,method,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, f in FAULTS])
def test_a_broken_path_is_not_correct(bench, monkeypatch, cell, method,
                                      fault):
    monkeypatch.setattr(Program, method, fault)
    r = gnnbench_cells.run(bench, cell)
    assert not r["correct"], r["checks"]


def test_a_graph_off_its_stated_edge_count_is_refused(tmp_path):
    from gnnbench import graphs

    t = json.loads((FOLDER / "traffic" / "pubmed.train.json").read_text())
    assert graphs.load_csr(t, tmp_path, print).num_edges == t["num_edges"]
    t["num_edges"] += 1
    with pytest.raises(ValueError):
        graphs.load_csr(t, tmp_path, print)
