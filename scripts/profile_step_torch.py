#!/usr/bin/env python
"""Where one training step of the PyTorch port spends its time on the card.

    python scripts/profile_step_torch.py gat:cora gmm:cora gat:pubmed gmm:pubmed

For each ``model:dataset`` cell it sets the trainer up at the bench width
(the trainer's ``BENCH_ARGV``: scripts/train_gat_torch.py with heads (4, 1),
hidden 64, attn_drop 0.3; scripts/train_gmm_torch.py with hidden 64, 3
kernels, pseudo dim 2), runs a
few warmup steps, times ``--steps`` unprofiled steps on the host clock
(ending in a synchronize), then traces the same number of steps with
``torch.profiler`` and sums the trace's device events by kernel name (the
profiler's own device total counts annotation spans twice).  Per step it
prints: host ms, kernels launched, device kernel ms, the device's idle
share (1 - kernel ms / host ms), and for each hand-written kernel its
launches and its own time per launch; then the matrix products and the
rest (elementwise, reductions, gathers, ``cat``, Adam).  The last line is
one JSON object with every number.  Needs a CUDA device.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import importlib.util
import json
import subprocess
import time

import torch

from dgnn_tpu_torch.utils import make_optimizer

# substrings of the hand-written kernels' names in a trace
OWN = ("bin_gat_fwd", "bin_gat_bwd", "dense_gat_fwd", "dense_gat_bwd",
       "bin_gmm_fwd", "bin_gmm_bwd", "dense_gmm_fwd", "dense_gmm_bwd")
GEMM = ("gemm", "cutlass", "cublas")


def load_trainer(kind):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"train_{kind}_torch.py")
    spec = importlib.util.spec_from_file_location(f"train_{kind}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_step(kind, trainer, r, lr, weight_decay):
    """A closure that takes one training step on the trainer's own model."""
    model, device = r["model"], r["feats"].device
    opt = make_optimizer(model, lr, weight_decay)
    gen = torch.Generator(device=device).manual_seed(0)
    if kind == "gmm":
        return lambda: trainer.train_step(
            model, opt, r["graph"], r["feats"], r["pseudo"], r["labels"],
            r["train_mask"], gen)
    seed_gen = torch.Generator().manual_seed(1)
    n_convs = len(model.convs)

    def step():
        seeds = torch.randint(0, 2 ** 32, (n_convs,), generator=seed_gen,
                              dtype=torch.int64).tolist()
        trainer.train_step(model, opt, r["graph"], r["feats"], r["labels"],
                           r["train_mask"], gen, seeds)

    return step


def profile_cell(kind, dataset, steps, warmup):
    trainer = load_trainer(kind)
    args = trainer.parser().parse_args(
        ["--dataset", dataset, *trainer.BENCH_ARGV, "--n-epochs", "4", "--device",
         "cuda"])
    r = trainer.run(args)  # set-up (and 4 steps of its own)
    step = make_step(kind, trainer, r, args.lr, args.weight_decay)
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            continue
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not by_name:
        raise RuntimeError("the profiler recorded no device event")

    def group(match):
        hit = [(n, us) for name, (n, us) in by_name.items() if match(name)]
        return sum(n for n, _ in hit), sum(us for _, us in hit)

    out = dict(cell=f"{kind}:{dataset}", steps=steps, host_ms_per_step=host_ms)
    n_all, us_all = group(lambda name: True)
    out["kernels_per_step"] = n_all / steps
    out["kernel_ms_per_step"] = us_all / 1e3 / steps
    out["device_idle_share"] = 1.0 - out["kernel_ms_per_step"] / host_ms
    own_us = 0.0
    for key in OWN:
        n, us = group(lambda name, key=key: key in name)
        if n:
            out[key] = dict(launches_per_step=n / steps,
                            ms_per_launch=us / 1e3 / n,
                            ms_per_step=us / 1e3 / steps)
            own_us += us
    _, gemm_us = group(lambda name: any(g in name.lower() for g in GEMM))
    out["gemm_ms_per_step"] = gemm_us / 1e3 / steps
    out["rest_ms_per_step"] = (us_all - own_us - gemm_us) / 1e3 / steps
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="+", help="model:dataset, model gat or gmm")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_step_torch: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    results = []
    for cell in args.cells:
        kind, dataset = cell.split(":")
        res = profile_cell(kind, dataset, args.steps, args.warmup)
        results.append(res)
        print(f"[profile] {cell} | {smi}")
        for key, val in res.items():
            print(f"[profile]   {key}: {val}")
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "cells": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
