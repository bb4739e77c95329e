#!/usr/bin/env python
"""Where one training step of the PyTorch port spends its time on the card.

    python scripts/profile_step_torch.py gat:cora gmm:cora gat:pubmed \
        gmm:pubmed edgeconv:modelnet
    python scripts/profile_step_torch.py gat:reddit gmm:reddit

For each ``model:dataset`` cell it sets the trainer up at the bench width
(the trainer's ``BENCH_ARGV``: scripts/train_gat_torch.py with heads (4, 1),
hidden 64, attn_drop 0.3; scripts/train_gmm_torch.py with hidden 64, 3
kernels, pseudo dim 2; scripts/train_edgeconv_torch.py at its defaults:
DGCNN on 64 synthetic clouds of 1024 points, k = 40; on reddit, the JAX
bench's reddit widths: bf16 feature gathers, and 2 Gaussian kernels for
MoNet, on the R-MAT graph at reddit's size, read from the trainers'
cache or built there), runs a
few warmup steps, times ``--steps`` unprofiled steps on the host clock
(ending in a synchronize), then traces the same number of steps with
``torch.profiler`` and sums the trace's device events by kernel name (the
profiler's own device total counts annotation spans twice).  Per step it
prints: host ms, kernels launched, device kernel ms, the device's idle
share (1 - kernel ms / host ms), and for each hand-written kernel its
launches and its own time per launch; then the matrix products and the
rest (elementwise, reductions, gathers, ``cat``, the optimizer).  The GAT
and MoNet cells do all of that twice: for the step issued from the host
(the trainer's ``make_step``) and under
``replayed``, for the same step captured once into a CUDA graph
(``utils.timing.StepGraph``, the trainers' device-resident loop) and
replayed, with the replays' device ms from CUDA events beside the trace's
kernel ms.  The
``edgeconv`` cell profiles the trainer's ``train_step`` issued from the
host and, under ``replayed``, the trainer's epoch (``make_epoch``: the
shuffle, the augmentation and every step of an epoch) captured once and
replayed, its numbers divided by the epoch's steps; then it takes the same
number of eager steps once more with CUDA events around every k-NN mask
build (``knn_mask_neg``) and every tie-sum backward (``tie_sum_bwd``, the
kernels of csrc/ec_ties.cu: its list pass and its sum), and prints each
span's calls and device-stream ms per step (idle gaps inside a span
included), and
counts the admitted columns a row of each layer's mask on one batch (mean,
most, rows over the masked-max lists' cap and over half of it).  The last
line is one JSON object with every number.  Needs a CUDA device.
"""


import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import copy
import importlib.util
import json
import subprocess
import time

import torch

from dgnn_tpu_torch.utils import StepGraph, make_optimizer, make_sgd_cosine
from dgnn_tpu_torch.utils.training import augment

# substrings of the hand-written kernels' names in a trace
OWN = ("bin_gat_fwd", "bin_gat_bwd", "dense_gat_fwd", "dense_gat_bwd",
       "bin_gmm_fwd", "bin_gmm_bwd", "dense_gmm_fwd", "dense_gmm_bwd",
       "ec_masked_max", "ec_live_list", "ec_hs_range", "ec_tie_sum",
       "ec_tie_list", "ec_tie_bounds")
GEMM = ("gemm", "cutlass", "cublas")


def load_trainer(kind):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"train_{kind}_torch.py")
    spec = importlib.util.spec_from_file_location(f"train_{kind}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_step(kind, trainer, r, args):
    """The trainer's own training step (``make_step``) on a copy of its
    trained model with a fresh optimizer and its generators; returns (step,
    generators)."""
    model, device = copy.deepcopy(r["model"]), r["feats"].device
    opt = make_optimizer(model, args.lr, args.weight_decay)
    count = torch.zeros(1, dtype=torch.int64, device=device)
    if kind == "gmm":
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return trainer.make_step(model, opt, r["graph"], r["feats"],
                                 r["pseudo"], r["labels"], r["train_mask"],
                                 gen, count), (gen,)
    gens = trainer.generators(args.seed, device)
    return trainer.make_step(model, opt, r["graph"], r["feats"], r["labels"],
                             r["train_mask"], gens, count), gens


def make_edgeconv_step(trainer, r, total_steps, bs):
    """A closure that takes one DGCNN training step (the trainer's
    ``train_step``) on a copy of the trainer's model with a fresh
    optimizer, walking the (augmented) training clouds batch by batch."""
    model, xs, ys = copy.deepcopy(r["model"]), r["x_train"], r["y_train"]
    opt = make_sgd_cosine(model, total_steps)
    gen = torch.Generator(device=xs.device).manual_seed(0)
    state = dict(i=0)

    def step():
        i = state["i"] % (xs.shape[0] // bs)
        state["i"] += 1
        x = augment(xs[i * bs:(i + 1) * bs], gen)
        trainer.train_step(model, opt, x, ys[i * bs:(i + 1) * bs], gen)

    return step


def make_edgeconv_epoch(trainer, r, total_steps, bs):
    """The trainer's epoch (``make_epoch``) on a copy of its model with a
    fresh optimizer; returns (epoch, generators)."""
    model, xs = copy.deepcopy(r["model"]), r["x_train"]
    opt = make_sgd_cosine(model, total_steps)
    gen = torch.Generator(device=xs.device).manual_seed(0)
    count = torch.zeros(1, dtype=torch.int64, device=xs.device)
    stats = torch.zeros(2, device=xs.device)
    return trainer.make_epoch(model, opt, xs, r["y_train"], bs, gen, count,
                              stats), (gen,)


class Spans:
    """CUDA events around every call of the functions it wraps: calls and
    device-stream ms between a call's first and last kernel."""

    def __init__(self):
        self.events = {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            return out

        return timed

    def per_step(self, steps):
        torch.cuda.synchronize()
        return {name: dict(calls_per_step=len(ev) / steps,
                           ms_per_step=sum(a.elapsed_time(b) for a, b in ev)
                           / steps)
                for name, ev in self.events.items()}


def edgeconv_spans(step, steps):
    """``steps`` more steps with the k-NN mask builds and the tie-sum
    backwards bracketed by CUDA events."""
    from dgnn_tpu_torch.models import dgcnn
    from dgnn_tpu_torch.ops import edgeconv

    spans = Spans()
    saved = dgcnn.knn_mask_neg, edgeconv.tie_sum_bwd
    dgcnn.knn_mask_neg = spans.wrap("knn_mask_neg", saved[0])
    edgeconv.tie_sum_bwd = spans.wrap("tie_sum_backward", saved[1])
    try:
        for _ in range(steps):
            step()
        return spans.per_step(steps)
    finally:
        dgcnn.knn_mask_neg, edgeconv.tie_sum_bwd = saved


def edgeconv_mask_stats(model, x):
    """Admitted columns a row of each layer's k-NN mask on one batch (an
    eval forward): what the masked-max kernels' lists have to hold."""
    from dgnn_tpu_torch.ops.ec_tiles import LIVE_CAP

    was_training = model.training
    model.eval()
    masks = []
    with torch.no_grad():
        model(x, masks_out=masks)
    model.train(was_training)
    stats = []
    for m in masks:
        n = (m == 0).sum(dim=-1)
        stats.append(dict(admitted_mean=float(n.float().mean()),
                          admitted_max=int(n.max()), rows=n.numel(),
                          rows_over_half_cap=int((n > LIVE_CAP // 2).sum()),
                          rows_over_cap=int((n > LIVE_CAP).sum()),
                          live_cap=LIVE_CAP))
    return stats


# the JAX bench's reddit configurations beyond the trainers' BENCH_ARGV
REDDIT_ARGV = {"gat": ["--gather-dtype", "bfloat16"],
               "gmm": ["--n-kernels", "2"]}


def measure(run, calls, replays=None, steps_per_call=1):
    """Host ms a step of ``run(calls)`` (unprofiled, ending in a
    synchronize), then a torch.profiler trace of it summed by kernel name;
    a call is ``steps_per_call`` steps (an epoch replay: its steps).
    ``replays``: the StepGraph ``run`` replays, whose device ms a step
    (CUDA events around ``calls`` replays) is added."""
    steps = calls * steps_per_call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(calls)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(calls)
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

    out = dict(host_ms_per_step=host_ms)
    if replays is not None:
        out["replay_device_ms_per_step"] = replays.seconds(calls) * 1e3 / steps
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


def profile_cell(kind, dataset, steps, warmup):
    trainer = load_trainer(kind)
    if kind == "edgeconv":
        if dataset != "modelnet":
            raise ValueError(f"edgeconv:{dataset}: the cell is "
                             "edgeconv:modelnet")
        args = trainer.parser().parse_args(["--num-epochs", "1", "--device",
                                            "cuda"])
        r = trainer.run(args)  # set-up (and its own timing and training)
        step = make_edgeconv_step(trainer, r, warmup + 3 * steps,
                                  args.batch_size)
    else:
        extra = REDDIT_ARGV[kind] if dataset == "reddit" else []
        args = trainer.parser().parse_args(
            ["--dataset", dataset, *trainer.BENCH_ARGV, *extra, "--n-epochs",
             "4", "--device", "cuda"])
        r = trainer.run(args)  # set-up (and its own timing and training)
        step, gens = make_step(kind, trainer, r, args)
    for _ in range(warmup):
        step()

    def eager(n):
        for _ in range(n):
            step()

    out = dict(cell=f"{kind}:{dataset}", steps=steps,
               **measure(eager, steps))
    if kind == "edgeconv":
        # the trainer's epoch from a CUDA graph, on a copy of its own
        # state: enough epochs for ``steps`` steps, read a step
        spe = r["steps_per_epoch"]
        epochs = max(1, -(-steps // spe))
        epoch, gens = make_edgeconv_epoch(trainer, r, (2 + 3 * epochs) * spe,
                                          args.batch_size)
        graph = StepGraph(epoch, r["x_train"].device, generators=gens,
                          warmup=1)
        try:
            graph.replay(1)
            out["replayed"] = measure(graph.replay, epochs, graph,
                                      steps_per_call=spe)
        finally:
            graph.close()
        out["spans"] = edgeconv_spans(step, steps)
        out["masks"] = edgeconv_mask_stats(r["model"],
                                           r["x_train"][:args.batch_size])
        return out
    # the same step from a CUDA graph, on a copy of its own state
    step, gens = make_step(kind, trainer, r, args)
    graph = StepGraph(step, r["feats"].device, generators=gens,
                      warmup=warmup)
    try:
        graph.replay(warmup)
        out["replayed"] = measure(graph.replay, steps, graph)
    finally:
        graph.close()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="+", help="model:dataset: gat or gmm on "
                    "cora, citeseer, pubmed or reddit; edgeconv:modelnet")
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
