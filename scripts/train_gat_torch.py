#!/usr/bin/env python
"""GAT training CLI for the PyTorch port (counterpart of scripts/train_gat.py).

Same flags and defaults as scripts/train_gat.py, plus ``--device`` (default
``cuda``), ``--gather-dtype``, ``--scale`` and ``--cache-dir``.  Same loss (masked mean cross-entropy over ``train_mask``) and
optimizer (Adam with coupled L2 weight decay, which is what
``optax.add_decayed_weights`` + ``optax.adam`` compute).  Prints train and
inference seconds per epoch, peak device memory and test accuracy, and
appends one CSV row named ``train_GAT_dgnn_tpu_torch_<impl>``.

``--impl naive`` runs the DGL-style baseline (ops/naive.py: per-edge
scores and messages materialised, segment sums over the raw CSR) in
place of the fused op, as the JAX CLI's ``--impl naive`` does; the graph
then keeps its raw CSR on the device, which the fused path drops
(``graph.slim()``).  On a multigraph with a hub block (synthetic cora and
citeseer) the two compute different functions: the block counts a
duplicate edge once, the baseline every copy.

It trains and times as the JAX CLI does (``scripts/train_gat.py:94-122``),
with the JAX package's device-resident loop ported as a replayed CUDA graph
(dgnn_tpu_torch/utils/timing.py): training is timed by ``time_epoch_loop``
on a throwaway copy of the model and optimizer state; the model then trains
exactly ``--n-epochs`` steps from its initial state by ``run_epochs`` (one
capture, ``--n-epochs`` replays), for the accuracy; inference is timed by
``time_epoch_loop`` over a no-grad forward.  Each step draws its feature
dropout and its attention-dropout seeds on the device, from generators
seeded by ``--seed`` and ``--seed + 1``, so every replay draws new ones;
the losses go to a device buffer, read once at the end.  ``--device cpu``
runs the same protocol in host loops.  The graph is built
with ``dense="auto"``, as the JAX trainer builds it: on cora and citeseer
the hub planner keeps a dense block, which the dense hub-block kernels
take, and the rest of the edges go through the degree bins.

``--dataset reddit`` takes the JAX CLI's reddit protocol
(``scripts/train_gat.py:30-50``): the R-MAT graph at reddit's size (cut by
``--scale``, as bench.py's scale), read from the port's cache under
``--cache-dir`` or built and cached there (dgnn_tpu_torch/data/reddit.py),
with its task derived from its own edges.  ``--gather-dtype bfloat16``
stores the gathered feature rows as bf16, as the JAX bench's reddit
configurations do (the JAX CLI keeps float32, this CLI's default).

    python scripts/train_gat_torch.py --dataset cora --n-heads 4 \
        --n-hidden 64 --attn-drop 0.3 --n-epochs 20
    python scripts/train_gat_torch.py --dataset reddit --n-heads 4 \
        --n-hidden 64 --gather-dtype bfloat16 --n-epochs 5 [--scale 0.25]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import copy

import torch

from dgnn_tpu_torch.data import load_citation_dataset
from dgnn_tpu_torch.data.reddit import load_reddit
from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.models import GAT
from dgnn_tpu_torch.utils import (append_csv_row, device_peak_memory_mb,
                                  make_optimizer, masked_loss,
                                  reset_peak_memory, run_epochs,
                                  time_epoch_loop)

# eager steps before a timing loop's capture
WARMUP_STEPS = 3
# The width of the JAX bench's gat_* configurations (bench.py): what the
# card smoke run and scripts/profile_step_torch.py train at.
BENCH_ARGV = ["--n-heads", "4", "--n-hidden", "64", "--dropout", "0.5",
              "--attn-drop", "0.3", "--lr", "1e-3", "--weight-decay", "5e-4"]


def train_step(model, opt, graph, feats, labels, train_mask, generator,
               attn_seeds):
    """One optimizer step; returns the (detached) loss before the step."""
    model.train()
    opt.zero_grad(set_to_none=True)
    logits = model(graph, feats, generator=generator, attn_seeds=attn_seeds)
    loss = masked_loss(logits, labels, train_mask)
    loss.backward()
    opt.step()
    return loss.detach()


def generators(seed: int, device) -> tuple:
    """(feature dropout, attention-dropout seeds): two generators on
    ``device`` seeded by ``seed`` and ``seed + 1``."""
    return (torch.Generator(device=device).manual_seed(seed),
            torch.Generator(device=device).manual_seed(seed + 1))


def draw_seeds(n: int, generator) -> torch.Tensor:
    """``n`` uint32 attention-dropout seeds drawn on the generator's device,
    held as the bits of int32, as the JAX model draws
    ``jax.random.bits(key, uint32)`` inside its step."""
    return torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32,
                         device=generator.device, generator=generator)


def make_step(model, opt, graph, feats, labels, train_mask, gens, count,
              losses=None):
    """One training step as ``time_epoch_loop`` and ``run_epochs`` take it:
    it draws the layers' attention seeds from ``gens[1]`` on the device,
    steps with feature dropout from ``gens[0]``, writes the loss to
    ``losses[count]`` (a device buffer, where given) and adds one to
    ``count`` (a [1] int64 device tensor)."""
    drop_gen, seed_gen = gens

    def step():
        seeds = draw_seeds(len(model.convs), seed_gen)
        loss = train_step(model, opt, graph, feats, labels, train_mask,
                          drop_gen, seeds)
        if losses is not None:
            losses.index_copy_(0, count, loss.reshape(1))
        count.add_(1)

    return step


def run(args) -> dict:
    """Train and evaluate as the CLI does; returns what it printed plus the
    trained model and its inputs.  ``train_steps`` and ``infer_calls`` are
    the steps and forwards the device ran, counted there: the timing
    loops' warmups and replays, the ``--n-epochs`` training steps and the
    final forward."""
    if args.n_epochs <= WARMUP_STEPS:
        raise ValueError(f"--n-epochs must exceed the {WARMUP_STEPS} warmup "
                         "steps")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")

    if args.dataset == "reddit":
        data = load_reddit(args.scale, seed=args.seed,
                           cache_dir=args.cache_dir)
        graph, setup_s = data.graph, data.seconds
        print(f"reddit scale {args.scale}: host set-up {setup_s}, host peak "
              f"RSS {data.host_peak_mb:.0f} MB")
    else:
        data = load_citation_dataset(args.dataset, seed=args.seed)
        graph = build_graph(data.src, data.dst, data.num_nodes, dense="auto",
                            edge_tables=False)
        setup_s = {}
    if args.impl == "fused":  # the naive baseline reads the raw CSR
        graph = graph.slim()
    graph = graph.to(device)
    feats = torch.from_numpy(data.features).to(device)
    labels = torch.from_numpy(data.labels).long().to(device)
    train_mask = torch.from_numpy(data.train_mask).to(device)
    test_mask = torch.from_numpy(data.test_mask).to(device)

    heads = [args.n_heads] * args.n_layers + [1]
    model = GAT(feats.shape[1], args.n_layers, args.n_hidden, data.n_classes,
                heads, feat_drop=args.dropout, attn_drop=args.attn_drop,
                negative_slope=args.negative_slope, impl=args.impl,
                gather_dtype=args.gather_dtype,
                generator=torch.Generator().manual_seed(args.seed)).to(device)
    opt = make_optimizer(model, args.lr, args.weight_decay)
    task = (graph, feats, labels, train_mask)

    def counter():
        return torch.zeros(1, dtype=torch.int64, device=device)

    print(args)
    print("profile training")
    # timing on a throwaway copy of the model and optimizer state; the
    # accuracy from EXACTLY n_epochs steps below (the timing loop runs
    # many more: utils.timing.run_epochs)
    model_t = copy.deepcopy(model)
    gens_t, timed = generators(args.seed, device), counter()
    train_s = time_epoch_loop(
        make_step(model_t, make_optimizer(model_t, args.lr,
                                          args.weight_decay),
                  *task, gens_t, timed),
        args.n_epochs, device=device, warmup=WARMUP_STEPS, generators=gens_t)
    del model_t
    gens, done = generators(args.seed, device), counter()
    losses = torch.zeros(args.n_epochs, device=device)
    reset_peak_memory(device)
    run_epochs(make_step(model, opt, *task, gens, done, losses),
               args.n_epochs, device=device, generators=gens)
    max_mb = device_peak_memory_mb(device)
    losses = losses.tolist()
    if args.verbose:
        print("final loss", losses[-1])

    print("profile inference")
    model.eval()
    calls = counter()

    def infer():
        with torch.no_grad():
            model(graph, feats)
        calls.add_(1)

    infer_s = time_epoch_loop(infer, args.n_epochs, device=device,
                              warmup=WARMUP_STEPS)
    with torch.no_grad():
        logits = model(graph, feats)
    pred = logits.argmax(dim=1)
    acc = float(((pred == labels) & test_mask).sum() / test_mask.sum())
    train_acc = float(((pred == labels) & train_mask).sum()
                      / train_mask.sum())
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    print(f"Test Accuracy {acc:.4f} (train {train_acc:.4f})")
    print(f"max memory:{max_mb:.0f}MB")
    print("train time:", train_s)
    print("inference time:", infer_s)

    if args.output is not None:
        append_csv_row(args.output, f"train_GAT_dgnn_tpu_torch_{args.impl}",
                       f"{args.dataset} heads={args.n_heads} "
                       f"hidden_dim={args.n_hidden}",
                       train_s, infer_s, max_mb, acc)
    return dict(losses=losses, train_s=train_s, infer_s=infer_s,
                impl=args.impl,
                peak_mb=max_mb, test_acc=acc, train_acc=train_acc,
                train_steps=int(timed) + int(done),
                infer_calls=int(calls) + 1,
                gather_dtype=args.gather_dtype, setup_s=setup_s,
                host_peak_mb=getattr(data, "host_peak_mb", None),
                model=model, graph=graph, feats=feats,
                labels=labels, train_mask=train_mask, logits=logits)


def parser():
    p = argparse.ArgumentParser(description="GAT (dgnn_tpu_torch)")
    p.add_argument("--dataset", type=str, default="cora")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--n-epochs", type=int, default=200)
    p.add_argument("--n-hidden", type=int, default=16)
    p.add_argument("--n-layers", type=int, default=1)
    p.add_argument("--n-heads", type=int, default=1)
    p.add_argument("--negative-slope", type=float, default=0.2)
    p.add_argument("--attn-drop", type=float, default=0.0)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--impl", type=str, default="fused",
                   choices=["fused", "naive"],
                   help="fused binned kernels vs DGL-style baseline")
    p.add_argument("--gather-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage of the gathered feature rows")
    p.add_argument("--scale", type=float, default=1.0,
                   help="reddit only: nodes and edges times this")
    p.add_argument("--cache-dir", type=str, default=None,
                   help="reddit only: where the host build is cached "
                        "(default: .bench_cache at the checkout's root)")
    p.add_argument("--device", type=str, default="cuda")
    return p


if __name__ == "__main__":
    run(parser().parse_args())
