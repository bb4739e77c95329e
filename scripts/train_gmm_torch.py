#!/usr/bin/env python
"""MoNet (GMMConv) training CLI for the PyTorch port (counterpart of
scripts/train_gmm.py).

Same flags and defaults as scripts/train_gmm.py, plus ``--device`` (default
``cuda``) and ``--pseudo`` (default ``node``).  Pseudo-coordinates are
node-derived, as in every gmm configuration of the JAX bench: the pseudo of
edge (u -> v) is [1/sqrt(deg_u), 1/sqrt(deg_v)] over in-degrees clamped at
1, handed to the model as per-node columns (``NodePseudo``) and projected
inside the fused op.  ``--pseudo binned`` (the pre-binned per-edge tables the
JAX CLI uses on the citation graphs) is not ported yet.

Same loss (masked mean cross-entropy over ``train_mask``) and optimizer
(Adam with coupled L2 weight decay, which is what
``optax.add_decayed_weights`` + ``optax.adam`` compute).  Prints train and
inference seconds per epoch, peak device memory and test accuracy, and
appends one CSV row named ``train_GMM_dgnn_tpu_torch``.

Training runs exactly ``--n-epochs`` steps; the steps after the first few
(warmup) are timed with CUDA events on a CUDA device.  The graph is built
with ``dense="auto"``: on cora and citeseer the hub planner keeps a dense
block, which the dense hub-block kernels take, and the rest of the edges go
through the degree bins.

    python scripts/train_gmm_torch.py --dataset cora --n-hidden 64 \
        --n-kernels 3 --pseudo-dim 2 --n-epochs 20
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import torch

from dgnn_tpu_torch.data import load_citation_dataset
from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.models import MoNet
from dgnn_tpu_torch.ops.gmm import NodePseudo
from dgnn_tpu_torch.utils import (append_csv_row, make_optimizer,
                                  masked_loss, peak_memory_mb,
                                  reset_peak_memory, time_calls)

WARMUP_STEPS = 3
# The width of the JAX bench's gmm_* configurations (bench.py): what the
# card smoke run and scripts/profile_step_torch.py train at.
BENCH_ARGV = ["--n-hidden", "64", "--n-kernels", "3", "--pseudo-dim", "2",
              "--n-layers", "1", "--dropout", "0.5", "--lr", "1e-2"]


def node_pseudo(graph) -> NodePseudo:
    """1 / sqrt(max(in-degree, 1)) as an [N, 1] column for both endpoints.
    Needs the raw CSR, so call it before ``graph.slim()``."""
    deg = graph.in_degrees().to(torch.float32).clamp(min=1.0)
    rsq = torch.rsqrt(deg)[:, None]
    return NodePseudo(src=rsq, dst=rsq)


def train_step(model, opt, graph, feats, pseudo, labels, train_mask,
               generator):
    """One optimizer step; returns the (detached) loss before the step."""
    model.train()
    opt.zero_grad(set_to_none=True)
    logits = model(graph, feats, pseudo, generator=generator)
    loss = masked_loss(logits, labels, train_mask)
    loss.backward()
    opt.step()
    return loss.detach()


def run(args) -> dict:
    """Train and evaluate as the CLI does; returns what it printed plus the
    trained model and its inputs."""
    if args.pseudo != "node":
        raise NotImplementedError(
            f"--pseudo {args.pseudo}: pre-binned per-edge pseudo tables "
            "(gmm_aggregate_binned) are not ported to dgnn_tpu_torch yet")
    if args.n_epochs <= WARMUP_STEPS:
        raise ValueError(f"--n-epochs must exceed the {WARMUP_STEPS} warmup "
                         "steps")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")

    data = load_citation_dataset(args.dataset, seed=args.seed)
    graph = build_graph(data.src, data.dst, data.num_nodes, dense="auto",
                        edge_tables=False)
    pseudo = NodePseudo(*(t.to(device) for t in node_pseudo(graph)))
    graph = graph.slim().to(device)
    feats = torch.from_numpy(data.features).to(device)
    labels = torch.from_numpy(data.labels).long().to(device)
    train_mask = torch.from_numpy(data.train_mask).to(device)
    test_mask = torch.from_numpy(data.test_mask).to(device)

    model = MoNet(feats.shape[1], args.n_hidden, data.n_classes,
                  args.n_layers, args.pseudo_dim, args.n_kernels,
                  dropout=args.dropout,
                  generator=torch.Generator().manual_seed(args.seed)
                  ).to(device)
    opt = make_optimizer(model, args.lr, args.weight_decay)
    drop_gen = torch.Generator(device=device).manual_seed(args.seed)

    losses = []

    def step():
        losses.append(train_step(model, opt, graph, feats, pseudo, labels,
                                 train_mask, drop_gen))

    print(args)
    print("profile training")
    reset_peak_memory(device)
    train_s = time_calls(step, device, iters=args.n_epochs - WARMUP_STEPS,
                         warmup=WARMUP_STEPS)
    max_mb = peak_memory_mb(device)
    losses = [float(x) for x in losses]

    print("profile inference")
    model.eval()
    with torch.no_grad():
        infer_s = time_calls(lambda: model(graph, feats, pseudo), device,
                             iters=args.n_epochs, warmup=WARMUP_STEPS)
        logits = model(graph, feats, pseudo)
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
        append_csv_row(args.output, "train_GMM_dgnn_tpu_torch",
                       f"{args.dataset} pseudo_dim={args.pseudo_dim} "
                       f"n_kernels={args.n_kernels} "
                       f"hidden_dim={args.n_hidden}",
                       train_s, infer_s, max_mb, acc)
    return dict(losses=losses, train_s=train_s, infer_s=infer_s,
                peak_mb=max_mb, test_acc=acc, train_acc=train_acc,
                train_steps=args.n_epochs,
                infer_calls=args.n_epochs + WARMUP_STEPS + 1,
                model=model, graph=graph, feats=feats, pseudo=pseudo,
                labels=labels, train_mask=train_mask, logits=logits)


def parser():
    p = argparse.ArgumentParser(description="MoNet (dgnn_tpu_torch)")
    p.add_argument("--dataset", type=str, default="cora")
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--n-epochs", type=int, default=200)
    p.add_argument("--n-hidden", type=int, default=16)
    p.add_argument("--n-layers", type=int, default=1)
    p.add_argument("--pseudo-dim", type=int, default=2)
    p.add_argument("--n-kernels", type=int, default=3)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pseudo", type=str, default="node",
                   choices=["node", "binned"],
                   help="node-derived pseudo-coordinates vs pre-binned "
                        "per-edge tables (binned is not ported yet)")
    p.add_argument("--device", type=str, default="cuda")
    return p


if __name__ == "__main__":
    run(parser().parse_args())
