"""Relative cost of the sharded GAT training step at P = 1, 2, 4 ranks.

    python scripts/shard_scaling_torch.py [--device cuda|cpu]

Port of scripts/measure_cpu_mesh_scaling.py: the same graphs
(``_graph(rng, n=16384, deg=16, locality)``, "local90" with 90 % of the
edges inside a +-n/64 id window and "uniform_worstcase" with none), the
same model (GAT, one hidden layer of 32 features x 4 heads, 7 classes,
Adam 1e-3, cross entropy over all n rows) and one full training step
timed at each P, one process a rank (parallel.run_ranks).

On one card the P ranks share the GPU, and on the CPU one host: T(P)
then measures the TOTAL work of the P-shard formulation, not its latency,
and the number that matters is work_ratio = T(P) / T(1), the overhead of
sharding (halo rows processed twice, padding, the exchanges), as the JAX
script's note says of its one core.  T(P) is the slowest rank's seconds a
step (the ranks meet at every exchange).  Prints one JSON line; writes
nothing (docs/cpu_mesh_scaling.json is the JAX script's record).
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from dgnn_tpu_torch.ops import _build
from dgnn_tpu_torch.parallel import partition_graph, run_ranks
from dgnn_tpu_torch.parallel.trainer import GATJob, train_gat_rank

N_NODES, DEG = 16384, 16  # the JAX script's graphs
SHARDS = (1, 2, 4)        # ranks, all on the one device
STEPS, WARMUP = 10, 3     # timed steps a case, after WARMUP more


def _graph(rng, n, deg, locality):
    """Edge list with a fraction ``locality`` of edges within a +-n/64 id
    window (what a locality-aware partition of a community graph looks
    like: range-chunk shards cut few windowed edges) and the rest uniform
    (the worst case: every edge crosses shards)."""
    e = deg * n
    n_loc = int(e * locality)
    src = rng.integers(0, n, e)
    off = rng.integers(-n // 64, n // 64 + 1, n_loc)
    dst = np.concatenate([
        (src[:n_loc] + off) % n,
        rng.integers(0, n, e - n_loc),
    ])
    return src, dst


def card():
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.stdout.strip().splitlines()[0]


def step_case(p, src, dst, n, feat, labels, device):
    shards = partition_graph(src, dst, n, p)
    job = GATJob(shards=shards, features=feat, labels=labels,
                 train_mask=np.ones(n, bool), n_classes=7, n_hidden=32,
                 heads=(4, 1), feat_drop=0.0, attn_drop=0.0,
                 weight_decay=0.0, steps=STEPS, warmup=WARMUP,
                 device=device)
    ranks = run_ranks(train_gat_rank, p, job, device=device)
    ex = ranks[0]["exchanges"]
    # each exchange of the forward sends P * Hmax rows of features ++
    # attn_col; the backward sends their gradients back
    return dict(seconds=max(r["step_s"] for r in ranks),
                halo_max=shards.halo_max,
                halo_rows_real=int(shards.halo_counts.sum()),
                halo_bytes_per_exchange=ex["bytes"] // max(ex["exchanges"], 1),
                route=ex["route"],
                peak_mb=max(r["peak_mb"] for r in ranks),
                loss=[sum(v) for v in zip(*(r["losses"] for r in ranks))])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch sees no CUDA device")
        _build.load()  # once, before the ranks load it
    rng = np.random.default_rng(0)
    n, deg = N_NODES, DEG
    feat = rng.normal(size=(n, 64)).astype(np.float32)
    labels = rng.integers(0, 7, n).astype(np.int32)
    out = {"nodes": n, "edges": int(deg * n), "device": args.device,
           "card": card() if args.device == "cuda" else None,
           "steps": STEPS,
           "note": ("P ranks share one device: T(P) ~ total work; "
                    "work_ratio = T(P)/T(1)"), "cases": {}}
    for tag, locality in (("local90", 0.9), ("uniform_worstcase", 0.0)):
        src, dst = _graph(rng, n, deg, locality)
        case = {}
        t1 = None
        for p in SHARDS:
            r = step_case(p, src, dst, n, feat, labels, args.device)
            t1 = t1 or r["seconds"]
            r["work_ratio"] = r["seconds"] / t1
            case[str(p)] = r
            print(f"[{tag}] P={p}: {r['seconds'] * 1e3:.3f} ms/step, work "
                  f"ratio {r['work_ratio']:.3f}, halo max {r['halo_max']} "
                  f"rows, {r['halo_bytes_per_exchange']} bytes an exchange "
                  f"a rank ({r['route']})", file=sys.stderr, flush=True)
        out["cases"][tag] = case
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
