"""Profiling and roofline accounting (port of ``dgnn_tpu/utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace (host and, where there is
one, CUDA activity) around a block and writes it as a Chrome trace.
``Roofline``, ``gat_epoch_hbm_bytes`` and ``gat_epoch_row_accesses`` are
counts and a ratio: the caller supplies the seconds and the peak rate it
measured or takes from a data sheet.  The JAX package's TPU rates
(``TPU_HBM_GBPS``, ``TPU_GATHER_ROWS_PER_S``) and the epoch time derived
from them (``expected_epoch_seconds``) have no counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path

import torch

__all__ = ["trace", "gat_epoch_hbm_bytes", "gat_epoch_row_accesses",
           "Roofline"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (CPU, and CUDA where torch sees
    a card) and write ``<logdir>/trace.json`` (chrome://tracing, Perfetto).
    Yields the profiler, whose ``key_averages()`` sum the events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


@dataclasses.dataclass
class Roofline:
    bytes_moved: float
    seconds: float
    peak_gbps: float

    @property
    def achieved_gbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e9

    @property
    def fraction_of_peak(self) -> float:
        return self.achieved_gbps / self.peak_gbps


def gat_epoch_hbm_bytes(num_edges: int, num_nodes: int, heads: int,
                        feat: int, in_dim: int, classes: int,
                        dtype_bytes: int = 4) -> float:
    """Lower-bound device-memory traffic of one fused-GAT training epoch
    (forward + backward) of the reference model shape (one hidden layer of
    heads * feat, one output layer) at the two-pass design: each layer
    gathers a feature row per edge once forward (CSR) and once backward
    (CSC), plus the dense projections' reads and writes."""
    hf = heads * feat * dtype_bytes
    hidden = 2 * num_edges * hf
    out_layer = 2 * num_edges * classes * dtype_bytes
    dense = 2 * 3 * num_nodes * (in_dim * heads * feat +
                                 heads * feat * classes) * dtype_bytes
    return float(hidden + out_layer + dense)


def _adj_rows(adj) -> int:
    """Row accesses of one pass over a binned adjacency: every padded slot
    is a gathered row, every segment a resident row."""
    slots = sum(int(n.numel()) for n in adj.nbr)
    segs = sum(int(r.shape[0]) for r in adj.row)
    return slots + segs


def gat_epoch_row_accesses(graph, num_layers: int = 2) -> int:
    """Row accesses of one training epoch at the two-pass design: per layer,
    one pass over the forward bins and one over the transposed bins."""
    return num_layers * (_adj_rows(graph.fwd) + _adj_rows(graph.bwd))
