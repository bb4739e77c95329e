"""utils/profiling.py: the trace writes a Chrome trace; the traffic and
row-access counts equal the JAX package's on the same graph."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import json

import numpy as np
import pytest
import torch

from dgnn_tpu.graph.structure import build_graph as jax_build_graph
from dgnn_tpu.utils import profiling as jprof
from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.utils import (Roofline, gat_epoch_hbm_bytes,
                                  gat_epoch_row_accesses, trace)
from tests.conftest import random_graph


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert events["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())


@pytest.mark.parametrize("dense", [None, (64, 150)])
def test_counts_equal_jax(rng, dense):
    src, dst = random_graph(rng, 300, 5, power_law=True)
    jg = jax_build_graph(src, dst, 300, dense=dense)
    tg = build_graph(src, dst, 300, dense=dense)
    for layers in (1, 2, 3):
        assert gat_epoch_row_accesses(tg, layers) \
            == jprof.gat_epoch_row_accesses(jg, layers)
    args = (114615892, 232965, 4, 64, 602, 41)
    assert gat_epoch_hbm_bytes(*args) == jprof.gat_epoch_hbm_bytes(*args)
    assert gat_epoch_hbm_bytes(*args, dtype_bytes=2) \
        == jprof.gat_epoch_hbm_bytes(*args, dtype_bytes=2)
    r, jr = Roofline(1e9, 0.5, 3350.0), jprof.Roofline(1e9, 0.5, 3350.0)
    np.testing.assert_allclose([r.achieved_gbps, r.fraction_of_peak],
                               [jr.achieved_gbps, jr.fraction_of_peak])
