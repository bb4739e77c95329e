#!/usr/bin/env python
"""Microbenchmarks of the neighbour-gather strategies on the card
(counterpart of scripts/microbench_gather.py).

1. PyTorch's row gather ``feat[idx]`` for [E] indices into [N, D], summed
   (what the plain versions of the bin kernels do).
2. ``gather_rows_sum``: the hand-written kernel of
   dgnn_tpu_torch/csrc/gather.cu that walks the table one column slice of
   32 floats (a 128-byte line of every row) at a time, a warp a segment's
   piece of the slice, so that each line of a row comes from device memory
   about once and its repeats from the L2; beside it its plain version
   (``feat[nbr].sum(1)``) and the one library call that computes the same
   function, ``torch.nn.functional.embedding_bag(mode="sum")`` (given the
   ids as int64, converted outside the timed region).  Its variants, and
   its time on a table the L2 holds whole: scripts/gather_variants_torch.py
   and chip_smoke.py.
3. ``gather_lanes``: the hand-written per-lane gather from a table held in
   shared memory one column slab at a time; beside it its plain version and
   ``torch.gather`` (given the widened int64 index, made outside the timed
   region).  For these two it also prints the GB/s of the bytes the function
   must move (table, int32 ids and output once each; ``torch.gather`` is
   given an int64 index of the output's shape and moves 2.4 times as much),
   and the time of one call inside a replayed CUDA graph of 20: at the small
   tables a call is shorter than the host takes to launch it.

At the JAX study's shapes: a [65536, sub, 128] float32 table and 2^20
gathered rows in segments of W, (W, sub) = (32, 8), (64, 8), (256, 8),
(64, 2); tables of c = 512 ... 4096 rows of 256 floats with 16 c rows of
128 lane indices.  Prints ms, GB/s of useful (gathered) bytes and rows/s for
each, by CUDA events, and the largest difference of each kernel from its
plain version; the last line is one JSON object with every number.  Useful
bytes count every named row; a rows case also prints how many distinct rows
its ids name, which is all of the table that the function must read.
``--device cpu`` runs the plain versions only.

    python scripts/microbench_gather_torch.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from dgnn_tpu_torch.ops import gather
from dgnn_tpu_torch.utils import time_calls

ROWS_CASES = ((32, 8), (64, 8), (256, 8), (64, 2))  # (W, sub)
LANES_CASES = (512, 1024, 2048, 4096)               # table rows c


def rows_tol(width):
    """Tolerance of a sum of ``width`` unit-scale terms taken in another
    order.  Float32 rounds every partial sum, of size about sqrt(width), so
    the rounding errors walk to about width * 2^-23; where the terms cancel
    the result is far smaller than its partial sums, so this part is
    absolute.  The factor 8 is set from readings, not derived: every rows
    case prints its largest error as a share of this atol (``err / atol``),
    and PERF.md keeps the largest share read over the cases and seeds."""
    return dict(rtol=1e-5, atol=8.0 * width * 2.0 ** -23)


def rows_inputs(device, n=65536, sub=8, e=1 << 20, width=64, seed=0):
    """(feat [n, sub, 128] float32, nbr [e / width, width] int32)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    feat = torch.randn((n, sub, 128), generator=gen, device=device)
    nbr = torch.randint(0, n, (e // width, width), generator=gen,
                        device=device, dtype=torch.int32)
    return feat, nbr


def lanes_inputs(device, c=2048, nlane=2, iters_inner=16, seed=0):
    """(tab [c, nlane * 128] float32, idx [iters_inner * c, 128] int32)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tab = torch.randn((c, nlane * 128), generator=gen, device=device)
    idx = torch.randint(0, c, (iters_inner * c, 128), generator=gen,
                        device=device, dtype=torch.int32)
    return tab, idx


def rows_library(feat, nbr_long):
    """The one PyTorch call that computes ``gather_rows_sum``."""
    return F.embedding_bag(nbr_long, feat.reshape(feat.shape[0], -1),
                           mode="sum")


def lanes_library(tab, idx_wide):
    """The one PyTorch call that computes ``gather_lanes``; ``idx_wide`` is
    ``idx.repeat(1, width / L).long()``."""
    return torch.gather(tab, 0, idx_wide)


def _rates(name, s, rows, row_bytes, err=None):
    return dict(variant=name, ms=s * 1e3, useful_gb_per_s=rows * row_bytes
                / s / 1e9, rows_per_s=rows / s, max_abs_err=err)


GRAPH_CALLS = 20


def graph_ms(fn, device, iters):
    """ms per call of ``fn()`` replayed from a CUDA graph that holds
    GRAPH_CALLS of them: the device's time, free of the host's."""
    fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    s = time_calls(graph.replay, device, iters=iters, warmup=2)
    return s * 1e3 / GRAPH_CALLS


def bench_index(device, n=65536, d=256, e=1 << 22, iters=10, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    feat = torch.randn((n, d), generator=gen, device=device)
    idx = torch.randint(0, n, (e,), generator=gen, device=device)
    s = time_calls(lambda: feat[idx].sum(0), device, iters=iters, warmup=2)
    return dict(case=dict(kind="index", E=e, D=d),
                rows=[_rates("feat[idx].sum(0)", s, e, d * 4)])


def bench_rows(device, width, sub, n=65536, e=1 << 20, iters=10, seed=0):
    device = torch.device(device)
    feat, nbr = rows_inputs(device, n, sub, e, width, seed)
    nbr_long = nbr.long()
    want = gather.gather_rows_sum_plain(feat, nbr)
    variants = [("plain feat[nbr].sum(1)",
                 lambda: gather.gather_rows_sum_plain(feat, nbr)),
                ("library embedding_bag",
                 lambda: rows_library(feat, nbr_long).view_as(want))]
    if device.type == "cuda":
        variants.insert(0, ("kernel gather_rows_sum",
                            lambda: gather.gather_rows_sum(feat, nbr)))
    rows = []
    for name, fn in variants:
        got = fn()
        torch.testing.assert_close(got, want, **rows_tol(width))
        s = time_calls(fn, device, iters=iters, warmup=2)
        rows.append(_rates(name, s, nbr.numel(), sub * 128 * 4,
                           float((got - want).abs().max())))
    atol = rows_tol(width)["atol"]
    return dict(case=dict(kind="rows", E=nbr.numel(), D=sub * 128, W=width,
                          distinct=int(torch.unique(nbr).numel()),
                          err_over_atol=max(r["max_abs_err"] for r in rows)
                          / atol),
                rows=rows)


def bench_lanes(device, c, nlane=2, iters_inner=16, iters=10, seed=0):
    device = torch.device(device)
    tab, idx = lanes_inputs(device, c, nlane, iters_inner, seed)
    idx_wide = idx.repeat(1, nlane).long()
    want = gather.gather_lanes_plain(tab, idx)
    variants = [("plain tab[idx, q]",
                 lambda: gather.gather_lanes_plain(tab, idx)),
                ("library torch.gather", lambda: lanes_library(tab, idx_wide))]
    if device.type == "cuda":
        variants.insert(0, ("kernel gather_lanes",
                            lambda: gather.gather_lanes(tab, idx)))
    # what the function must move: the table, the ids and the output once
    must = (tab.numel() + idx.numel() + want.numel()) * 4
    rows = []
    for name, fn in variants:
        got = fn()
        assert torch.equal(got, want), f"{name}: differs at c={c}"
        s = time_calls(fn, device, iters=iters, warmup=2)
        row = _rates(name, s, idx.shape[0], nlane * 128 * 4, 0.0)
        row["must_move_gb_per_s"] = must / s / 1e9
        if device.type == "cuda" and not name.startswith("plain"):
            row["graph_ms"] = graph_ms(fn, device, iters)
        rows.append(row)
    return dict(case=dict(kind="lanes", E=idx.shape[0], D=nlane * 128, C=c,
                          slab=gather.lane_slab_width(c, nlane * 128),
                          must_move_bytes=must),
                rows=rows)


def study(device, iters=10, scale=1, seed=0):
    """Every case of the JAX study; ``scale`` divides the sizes (tests)."""
    out = [bench_index(device, 65536 // scale, 256, (1 << 22) // scale, iters,
                       seed)]
    for width, sub in ROWS_CASES:
        out.append(bench_rows(device, width, sub, 65536 // scale,
                              (1 << 20) // scale, iters, seed))
    for c in LANES_CASES:
        out.append(bench_lanes(device, c // scale, iters=iters, seed=seed))
    return out


def card(device):
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every size by this (a quick look)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("microbench_gather_torch: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    res = dict(card=card(args.device),
               cases=study(args.device, args.iters, args.scale, args.seed))
    for case in res["cases"]:
        print(f"[gather] {case['case']} | {res['card']}")
        for r in case["rows"]:
            err = ("" if r["max_abs_err"] is None
                   else f"  max err {r['max_abs_err']:.1e}")
            if "must_move_gb_per_s" in r:
                err += f"  {r['must_move_gb_per_s']:8.1f} GB/s of what must move"
            if "graph_ms" in r:
                err += f"  {r['graph_ms']:.4f} ms in a CUDA graph"
            print(f"[gather]   {r['variant']:24s}: {r['ms']:9.4f} ms  "
                  f"{r['useful_gb_per_s']:8.1f} GB/s useful  "
                  f"{r['rows_per_s'] / 1e6:8.1f} M rows/s{err}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
