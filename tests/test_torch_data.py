"""The port's data layer against the JAX package's: the loaders' default
data directory (``data_dir``), and the reddit graph cache's key, which
names the constants the cached layout depends on."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import numpy as np
import pytest

from dgnn_tpu.data import loaders as jloaders
from dgnn_tpu_torch.data import data_dir, load_citation_dataset, reddit
from dgnn_tpu_torch.graph import binning, hub
from dgnn_tpu_torch.graph import cache as gcache


def test_data_dir_defaults_to_the_jax_packages(tmp_path, monkeypatch):
    """With no ``$DGNN_TPU_DATA`` both packages look under
    ``~/.dgnn_tpu/data``, and the port's citation loader reads a file it
    finds there; the variable, when set, wins in both."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("DGNN_TPU_DATA", raising=False)
    root = tmp_path / ".dgnn_tpu" / "data"
    assert data_dir() == jloaders.data_dir() == str(root)
    rng = np.random.default_rng(0)
    n, f = 6, 3
    arrays = dict(src=np.array([0, 1, 2, 3, 4, 5], np.int32),
                  dst=np.array([1, 2, 3, 4, 5, 0], np.int32),
                  features=rng.normal(size=(n, f)).astype(np.float64),
                  labels=np.array([0, 1, 2, 0, 1, 2], np.int64),
                  train_mask=np.array([1, 1, 0, 0, 0, 0], bool),
                  val_mask=np.array([0, 0, 1, 1, 0, 0], bool),
                  test_mask=np.array([0, 0, 0, 0, 1, 1], bool))
    root.mkdir(parents=True)
    np.savez(root / "tiny.npz", **arrays)
    got = load_citation_dataset("tiny")
    want = jloaders.load_citation_dataset("tiny")
    assert got.num_nodes == want.num_nodes == n
    assert got.n_classes == want.n_classes == 3
    for name in arrays:
        np.testing.assert_array_equal(getattr(got, name), arrays[name]
                                      if name not in ("features", "labels")
                                      else getattr(want, name))
    assert got.features.dtype == np.float32 and got.labels.dtype == np.int32
    monkeypatch.setenv("DGNN_TPU_DATA", str(tmp_path / "elsewhere"))
    assert data_dir() == jloaders.data_dir() == str(tmp_path / "elsewhere")


def test_graph_key_is_stable():
    assert reddit.graph_key() == reddit.graph_key()
    assert len(reddit.graph_key()) == 12


@pytest.mark.parametrize("module,name,value", [
    (binning, "_BIN_PENALTY_SLOTS", 4096),
    (binning, "DEFAULT_WIDTHS", (8, 32, 128)),
    (binning, "_WIDTH_CANDIDATES", (4, 8, 16)),
    (hub, "DENSE_PAIRS_PER_S", 1e12),
    (hub, "GATHER_ROWS_PER_S", 1e9),
    (hub, "SPARSE_PAD", 1.5),
    (hub, "MIN_SAVE_S", 1e-6),
    (hub, "DENSE_CT", 1024),
    (gcache, "LAYOUT", "d7"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_graph_key_names_the_build_constants(monkeypatch, module, name,
                                             value):
    """A changed binning or planner constant, or another file layout,
    gives the reddit graph another cache file, so a graph built under the
    old constants is rebuilt, never loaded."""
    before = reddit.graph_key()
    target = reddit if module is gcache else module
    monkeypatch.setattr(target, name, value)
    assert reddit.graph_key() != before


def test_graph_key_names_the_planners_defaults(monkeypatch):
    before = reddit.graph_key()

    def plan_dense(row_ptr, col_ind, out_deg, *, mask_budget_bytes=1 << 20,
                   heads=4):
        raise AssertionError("not called")

    monkeypatch.setattr(hub, "plan_dense", plan_dense)
    assert reddit.graph_key() != before
