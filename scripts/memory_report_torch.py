#!/usr/bin/env python
"""Peak device memory of the GAT training step at reddit's size, fused
against naive (counterpart of scripts/memory_report.py).

The step is the JAX script's (``scripts/memory_report.py:19-45``): GAT with
one hidden layer of 64 features, heads (4, 1), feature dropout 0.5, no
attention dropout; Adam (lr 1e-3) with coupled L2 weight decay 5e-4
(``utils/training.py`` ``make_optimizer``); cross entropy averaged over
every node.  Its inputs are the JAX script's too (``:64-75``): the R-MAT
graph at reddit's size (``data/reddit.py`` ``load_reddit``), 602 standard
normal features and labels in [0, 41) drawn from ``default_rng(0)``; the
fused step gets ``graph.slim()``, the naive step (``ops/naive.py``, the
DGL-style baseline) the graph with its raw CSR.

The JAX script reads XLA's static analysis of the compiled step and never
runs the naive step.  This one runs both on the card and reads three
kinds of figure, each labelled so in its output:

- **measured**: after one warmup step (Adam's state then exists), the
  bytes the step's tensors hold on the card (graph, features, labels,
  parameters, optimizer state: "resident"), then the peak of one more
  eager step (``torch.cuda.max_memory_allocated`` after
  ``reset_peak_memory_stats``), both above what the process held before;
- **counted**: the bytes of the distinct storages autograd saves in one
  step (``saved_tensors_hooks``), split by leading dimension (edges E,
  nodes N, other); a lower bound of the peak, since transients such as the
  [E, H, F] message product are not saved;
- **fitted**: the naive step does not fit on the card at scale 1 (its
  [E, 4, 64] float32 messages alone are about 117 GB), so it is measured
  at cut scales (``--scales``, stopping before a scale whose peak,
  predicted in proportion from the largest scale run, would pass 75 % of
  the card's memory), and peak = a + b * scale is fitted by least squares
  through them and read at scale 1, beside its saved bytes extrapolated to
  scale 1 dimension by dimension.

The fused step runs at the same cut scales and at scale 1, there with
float32 gathers (the JAX script's configuration) and with bf16 gathers
(the bench's reddit configurations).  Every row checks its kernel launches:
the fused step launches exactly the bin and hub-block GAT kernels its
layers and bins imply, the naive step none.  Writes ``docs/MEMORY_torch.md``
(``--out``).  Measures only on a CUDA device.

    python scripts/memory_report_torch.py [--scales 0.015625 0.03125 ...]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from dgnn_tpu_torch.data.reddit import load_reddit
from dgnn_tpu_torch.models import GAT
from dgnn_tpu_torch.ops import all_launches, bins
from dgnn_tpu_torch.utils import (device_peak_memory_mb, make_optimizer,
                                  reset_peak_memory)

__all__ = ["build_model", "make_inputs", "make_step", "saved_bytes",
           "step_peak_mb", "fit_peak", "extrapolate", "expected_launches",
           "measure", "run", "markdown", "parser", "main"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = 1024 * 1024
N_FEATS, N_CLASSES = 602, 41
HIDDEN, HEADS = 64, (4, 1)
FEAT_DROP = 0.5
LR, WEIGHT_DECAY = 1e-3, 5e-4
SCALES = (1 / 64, 1 / 32, 1 / 16, 1 / 8)
# the share of the card's memory a cut scale's predicted naive peak may take
FIT_SHARE = 0.75
STEPS = 3  # a row's steps: the warmup, the measured step, the counted step
# the reference's published figures on real Reddit (dgNN's test/gat_result.csv)
REF_DGNN_MB, REF_DGL_MB = 8283, 22467


def build_model(impl: str, gather_dtype=None,
                feat_drop: float = FEAT_DROP) -> GAT:
    """The JAX script's GAT on the CPU, its weights drawn from seed 0."""
    return GAT(N_FEATS, 1, HIDDEN, N_CLASSES, HEADS, feat_drop=feat_drop,
               attn_drop=0.0, impl=impl, gather_dtype=gather_dtype,
               generator=torch.Generator().manual_seed(0))


def make_inputs(n: int, device):
    """The JAX script's features [n, 602] float32 and labels [n] (int64 for
    the loss), drawn from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(n, N_FEATS)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, n)
    return (torch.from_numpy(feat).to(device),
            torch.from_numpy(labels).long().to(device))


def make_step(model: GAT, graph, feat, labels):
    """``step()``: one training step of ``model`` (already on the inputs'
    device), its feature dropout drawn from a generator seeded 0; returns
    the loss, detached.  The gradients are dropped after the optimizer's
    step, so that between steps only the parameters and the optimizer's
    state stay."""
    opt = make_optimizer(model, LR, WEIGHT_DECAY)
    gen = torch.Generator(device=feat.device).manual_seed(0)
    model.train()

    def step():
        loss = F.cross_entropy(model(graph, feat, generator=gen), labels)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    return step


def saved_bytes(step, num_nodes: int, num_edges: int) -> dict:
    """Bytes of the distinct storages that autograd saves in one ``step()``,
    by the leading dimension of the tensor that saved each first: "E"
    (``num_edges``), "N" (``num_nodes``) or "other"; with "total", the
    step's "loss" and "tensors" (shape, dtype, bytes of each storage).  A
    lower bound of the step's peak: transients are not saved."""
    seen = {}

    def pack(t):
        storage = t.untyped_storage()
        key = (str(t.device), storage.data_ptr())
        if key not in seen:
            lead = t.shape[0] if t.dim() else None
            dim = ("E" if lead == num_edges else
                   "N" if lead == num_nodes else "other")
            seen[key] = (dim, tuple(t.shape), str(t.dtype), storage.nbytes())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = step()
    out = dict.fromkeys(("E", "N", "other"), 0)
    for dim, _, _, nbytes in seen.values():
        out[dim] += nbytes
    out["total"] = sum(out[k] for k in ("E", "N", "other"))
    out["loss"] = float(loss)
    out["tensors"] = [v[1:] for v in seen.values()]
    return out


def step_peak_mb(step, device, held_bytes: int = 0) -> dict:
    """One warmup ``step()``, the resident MB, then the peak MB of one more
    step, both above ``held_bytes`` (what the process held before the
    step's tensors were made).  Raises on a device other than CUDA: nothing
    is measured there."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"step_peak_mb measures device memory on a CUDA "
                           f"device, not on {dev}")
    step()
    torch.cuda.synchronize(dev)
    resident = (torch.cuda.memory_allocated(dev) - held_bytes) / MB
    reset_peak_memory(dev)
    loss = step()
    torch.cuda.synchronize(dev)
    peak = device_peak_memory_mb(dev) - held_bytes / MB
    return dict(resident_mb=resident, peak_mb=peak, loss=float(loss))


def fit_peak(scales, peaks) -> dict:
    """Least-squares line peak = a + b * scale through at least three
    points: a, b, its value at scale 1 and the largest relative residual
    |fit - peak| / peak over the points."""
    x = np.asarray(scales, np.float64)
    y = np.asarray(peaks, np.float64)
    if x.shape != y.shape or x.size < 3 or np.unique(x).size < 2:
        raise ValueError(f"fit_peak needs at least 3 points at 2 or more "
                         f"scales, got scales {list(x)}")
    b, a = np.polyfit(x, y, 1)
    resid = np.abs(a + b * x - y) / np.abs(y)
    return dict(a=float(a), b=float(b), at_one=float(a + b),
                max_rel_residual=float(resid.max()))


def extrapolate(saved: dict, nodes: int, edges: int, nodes_1: int,
                edges_1: int) -> float:
    """Saved bytes counted at (nodes, edges) carried to (nodes_1, edges_1):
    the E part in proportion to the edges, the N part to the nodes, the
    rest (parameters) as it is."""
    return (saved["E"] * edges_1 / edges + saved["N"] * nodes_1 / nodes
            + saved["other"])


def expected_launches(graph, impl: str, gather_dtype, steps: int,
                      layers: int) -> dict:
    """The launches ``steps`` training steps of a ``layers``-layer GAT imply,
    every key of ``all_launches()``: a fused forward one bin launch for every
    ``MAX_BINS_PER_LAUNCH`` bins of the CSR direction (the instance of its
    gathered rows' type) and one hub-block launch where the direction has a
    block, a backward the same over the CSC direction; the naive step
    none (plain PyTorch)."""
    want = dict.fromkeys(all_launches(), 0)
    if impl == "naive":
        return want
    bf16 = gather_dtype in ("bfloat16", torch.bfloat16)
    calls = steps * layers
    for name, adj, dname in (("bin_gat_fwd", graph.fwd, "dense_gat_fwd"),
                             ("bin_gat_bwd", graph.bwd, "dense_gat_bwd")):
        per_call = -(-adj.num_bins // bins.MAX_BINS_PER_LAUNCH)
        want[bins.launch_name(name, bf16)] = calls * per_call
        want[dname] = calls * (adj.dense is not None)
    return want


def measure(impl: str, graph, scale: float, device,
            gather_dtype=None) -> dict:
    """One row: ``impl``'s step on ``graph`` (slimmed for the fused step)
    at ``scale``, its resident and peak MB (measured), its saved bytes
    (counted) and its launches, which must be exactly the expected ones.
    Frees what it made before it returns."""
    dev = torch.device(device)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    g = (graph.slim() if impl == "fused" else graph).to(dev)
    feat, labels = make_inputs(graph.num_nodes, dev)
    model = build_model(impl, gather_dtype).to(dev)
    step = make_step(model, g, feat, labels)
    before = all_launches()
    row = step_peak_mb(step, dev, held)
    saved = saved_bytes(step, graph.num_nodes, graph.num_edges)
    launches = {k: v - before[k] for k, v in all_launches().items()}
    want = expected_launches(g, impl, gather_dtype, STEPS, len(model.convs))
    if launches != want:
        raise RuntimeError(f"{impl} scale {scale}: launches {launches}, "
                           f"expected {want}")
    losses = (row.pop("loss"), saved.pop("loss"))
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{impl} scale {scale}: losses {losses}")
    row.update(impl=impl, gather_dtype=str(gather_dtype or "float32"),
               scale=scale, nodes=graph.num_nodes, edges=graph.num_edges,
               saved=saved, losses=losses,
               launches={k: v for k, v in launches.items() if v})
    del g, feat, labels, model, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run(device="cuda", cache_dir=None, scales=SCALES, log=print) -> dict:
    """Every row of the report: naive and fused at each cut scale that fits,
    the naive fit and its counted bytes at scale 1, fused float32 and bf16
    at scale 1.  Returns dict(rows, fit, counted_mb, device, torch,
    nvidia_smi, total_mb, stopped)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the memory report measures on a CUDA device, "
                           f"not on {dev}")
    total_mb = torch.cuda.get_device_properties(dev).total_memory / MB
    # cuBLAS takes its workspaces from the caching allocator at its first
    # matmuls: take them here, so that the first row does not count them
    w = torch.ones(8, 8, device=dev, requires_grad=True)
    F.linear(w, w).sum().backward()
    del w
    quiet = lambda msg: None  # noqa: E731
    rows, naive, stopped = [], [], []
    for scale in sorted(scales):
        if naive:
            last = naive[-1]
            predicted = last["peak_mb"] * scale / last["scale"]
            if predicted > FIT_SHARE * total_mb:
                stopped.append((scale, predicted))
                log(f"scale {scale:g}: naive peak predicted {predicted:,.0f} "
                    f"MB, over {FIT_SHARE:.0%} of {total_mb:,.0f} MB: "
                    "stopped")
                break
        graph = load_reddit(scale, cache_dir=cache_dir, log=quiet).graph
        for impl in ("naive", "fused"):
            rows.append(measure(impl, graph, scale, dev))
            log(row_line(rows[-1]))
        naive.append(rows[-2])
        del graph
    fit = fit_peak([r["scale"] for r in naive], [r["peak_mb"] for r in naive])
    graph = load_reddit(1.0, cache_dir=cache_dir, log=quiet).graph
    for gather_dtype in (None, "bfloat16"):
        rows.append(measure("fused", graph, 1.0, dev, gather_dtype))
        log(row_line(rows[-1]))
    top = naive[-1]
    counted = extrapolate(top["saved"], top["nodes"], top["edges"],
                          graph.num_nodes, graph.num_edges) / MB
    log(f"naive at scale 1: fitted {fit['at_one']:,.1f} MB (largest relative "
        f"residual {fit['max_rel_residual']:.4f} over {len(naive)} scales); "
        f"counted saved {counted:,.1f} MB (scale {top['scale']:g}'s saved "
        "bytes extrapolated, a lower bound)")
    return dict(rows=rows, fit=fit, counted_mb=counted, nodes=graph.num_nodes,
                edges=graph.num_edges, device=torch.cuda.get_device_name(dev),
                nvidia_smi=nvidia_smi(), torch=torch.__version__,
                total_mb=total_mb, stopped=stopped)


def row_line(r: dict) -> str:
    s = r["saved"]
    return (f"{r['impl']} {r['gather_dtype']} scale {r['scale']:g} "
            f"({r['nodes']} nodes, {r['edges']} edges): resident "
            f"{r['resident_mb']:,.1f} MB, peak {r['peak_mb']:,.1f} MB "
            f"(measured); saved {s['total'] / MB:,.1f} MB (counted: E "
            f"{s['E'] / MB:,.1f}, N {s['N'] / MB:,.1f}, other "
            f"{s['other'] / MB:,.1f}); losses {r['losses'][0]:.4f}, "
            f"{r['losses'][1]:.4f}; launches {r['launches']}")


def markdown(res: dict) -> str:
    """The report as Markdown: one row per (implementation, gather dtype,
    scale), each figure labelled measured, fitted or counted."""
    fit = res["fit"]
    lines = [
        "# Peak device memory at reddit's size: fused against naive GAT "
        "training step (PyTorch port)",
        "",
        "Written by `scripts/memory_report_torch.py` on "
        f"{res['nvidia_smi']} (nvidia-smi: name, power limit), torch "
        f"{res['torch']}.",
        "",
        "The step of `scripts/memory_report.py`: GAT, 1 hidden layer of 64, "
        "heads (4, 1), feat_drop 0.5, attn_drop 0, Adam lr 1e-3 with "
        "coupled weight decay 5e-4, cross entropy over all nodes, 602 "
        "random features, 41 classes, on the R-MAT stand-in for reddit "
        f"({res['nodes']:,} nodes, {res['edges']:,} edges with self loops "
        "at scale 1; a scale cuts nodes and edges). The fused step runs on "
        "`graph.slim()`, the naive step (`ops/naive.py`, per-edge tensors "
        "materialised) on the raw CSR.",
        "",
        "- *measured*: MB above what the process held before, "
        "`torch.cuda.memory_allocated` after a warmup step (resident: "
        "graph, features, labels, parameters, Adam's state) and "
        "`torch.cuda.max_memory_allocated` over one more eager step (peak);",
        "- *counted*: the distinct storages autograd saves in one step "
        "(`saved_tensors_hooks`), a lower bound of the peak (transients "
        "such as the [E, H, F] message product are not saved);",
        "- *fitted*: peak = a + b * scale by least squares through the "
        "naive step's cut scales, read at scale 1, where it does not fit "
        f"on the card ({res['total_mb']:,.0f} MB).",
        "",
        "| implementation | gather dtype | scale | MB resident | MB peak | "
        "MB saved |",
        "| --- | --- | --- | --- | --- | --- |",
    ]
    for r in res["rows"]:
        lines.append(
            f"| {r['impl']} | {r['gather_dtype']} | {r['scale']:g} | "
            f"{r['resident_mb']:,.1f} measured | {r['peak_mb']:,.1f} "
            f"measured | {r['saved']['total'] / MB:,.1f} counted |")
    lines.append(
        f"| naive | float32 | 1 | not measured | {fit['at_one']:,.1f} "
        f"fitted | {res['counted_mb']:,.1f} counted (extrapolated) |")
    fused1 = next(r for r in res["rows"] if r["impl"] == "fused"
                  and r["scale"] == 1 and r["gather_dtype"] == "float32")
    lines += [
        "",
        f"The fit: a = {fit['a']:,.1f} MB, b = {fit['b']:,.1f} MB a unit of "
        f"scale, largest relative residual {fit['max_rel_residual']:.4f} "
        f"(fitted). Naive at scale 1 against fused float32 at scale 1: "
        f"{fit['at_one'] / fused1['peak_mb']:.1f} times the peak (fitted "
        "against measured).",
    ]
    if res["stopped"]:
        lines.append("Scales left out, their predicted naive peak over "
                     f"{FIT_SHARE:.0%} of the card: " + ", ".join(
                         f"{s:g} ({p:,.0f} MB predicted)"
                         for s, p in res["stopped"]) + ".")
    lines += [
        "",
        "The hub block counts a multi-edge once and the naive step every "
        "copy, so on this R-MAT multigraph the two compute slightly "
        "different functions; that does not change which of them holds the "
        "[E, H, F] tensors.",
        "",
        f"For comparison only: dgNN's and DGL's published figures on real "
        f"Reddit, on the reference's GPU, are {REF_DGNN_MB:,} MB and "
        f"{REF_DGL_MB:,} MB (dgNN's test/gat_result.csv).",
        "",
    ]
    return "\n".join(lines)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="the CUDA device to measure on (default cuda)")
    p.add_argument("--cache-dir", default=None,
                   help="the reddit graph cache (default .bench_cache/)")
    p.add_argument("--scales", type=float, nargs="+", default=list(SCALES),
                   help="the cut scales for the naive fit (at least 3)")
    p.add_argument("--out", default=os.path.join(ROOT, "docs",
                                                 "MEMORY_torch.md"))
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    res = run(args.device, args.cache_dir, args.scales,
              log=lambda msg: print(msg, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write(markdown(res))
    print("wrote", args.out)
    return res


if __name__ == "__main__":
    main()
