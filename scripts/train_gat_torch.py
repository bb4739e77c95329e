#!/usr/bin/env python
"""GAT training CLI for the PyTorch port (counterpart of scripts/train_gat.py).

Same flags and defaults as scripts/train_gat.py, plus ``--device`` (default
``cuda``).  Same loss (masked mean cross-entropy over ``train_mask``) and
optimizer (Adam with coupled L2 weight decay, which is what
``optax.add_decayed_weights`` + ``optax.adam`` compute).  Prints train and
inference seconds per epoch, peak device memory and test accuracy, and
appends one CSV row named ``train_GAT_dgnn_tpu_torch_fused``.

Training runs exactly ``--n-epochs`` steps; the steps after the first few
(warmup) are timed with CUDA events on a CUDA device.  The graph is built
with ``dense="auto"``, as the JAX trainer builds it: on cora and citeseer
the hub planner keeps a dense block, which the dense hub-block kernels
take, and the rest of the edges go through the degree bins.

    python scripts/train_gat_torch.py --dataset cora --n-heads 4 \
        --n-hidden 64 --attn-drop 0.3 --n-epochs 20
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import torch

from dgnn_tpu_torch.data import load_citation_dataset
from dgnn_tpu_torch.graph.structure import build_graph
from dgnn_tpu_torch.models import GAT
from dgnn_tpu_torch.utils import (append_csv_row, make_optimizer,
                                  masked_loss, peak_memory_mb,
                                  reset_peak_memory, time_calls)

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


def run(args) -> dict:
    """Train and evaluate as the CLI does; returns what it printed plus the
    trained model and its inputs."""
    if args.impl != "fused":
        raise NotImplementedError(f"--impl {args.impl}: the DGL-style naive "
                                  "baseline is not ported to dgnn_tpu_torch")
    if args.n_epochs <= WARMUP_STEPS:
        raise ValueError(f"--n-epochs must exceed the {WARMUP_STEPS} warmup "
                         "steps")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")

    data = load_citation_dataset(args.dataset, seed=args.seed)
    graph = build_graph(data.src, data.dst, data.num_nodes, dense="auto",
                        edge_tables=False).slim().to(device)
    feats = torch.from_numpy(data.features).to(device)
    labels = torch.from_numpy(data.labels).long().to(device)
    train_mask = torch.from_numpy(data.train_mask).to(device)
    test_mask = torch.from_numpy(data.test_mask).to(device)

    heads = [args.n_heads] * args.n_layers + [1]
    model = GAT(feats.shape[1], args.n_layers, args.n_hidden, data.n_classes,
                heads, feat_drop=args.dropout, attn_drop=args.attn_drop,
                negative_slope=args.negative_slope,
                generator=torch.Generator().manual_seed(args.seed)).to(device)
    opt = make_optimizer(model, args.lr, args.weight_decay)
    drop_gen = torch.Generator(device=device).manual_seed(args.seed)
    seed_gen = torch.Generator().manual_seed(args.seed + 1)
    n_convs = len(model.convs)

    losses = []

    def step():
        seeds = torch.randint(0, 2 ** 32, (n_convs,), generator=seed_gen,
                              dtype=torch.int64).tolist()
        losses.append(train_step(model, opt, graph, feats, labels,
                                 train_mask, drop_gen, seeds))

    print(args)
    print("profile training")
    reset_peak_memory(device)
    train_s = time_calls(step, device, iters=args.n_epochs - WARMUP_STEPS,
                         warmup=WARMUP_STEPS)
    max_mb = peak_memory_mb(device)
    losses = [float(x) for x in losses]
    if args.verbose:
        print("final loss", losses[-1])

    print("profile inference")
    model.eval()
    with torch.no_grad():
        infer_s = time_calls(lambda: model(graph, feats), device,
                             iters=args.n_epochs, warmup=WARMUP_STEPS)
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
                peak_mb=max_mb, test_acc=acc, train_acc=train_acc,
                train_steps=args.n_epochs,
                infer_calls=args.n_epochs + WARMUP_STEPS + 1,
                model=model, graph=graph, feats=feats, labels=labels,
                train_mask=train_mask, logits=logits)


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
                   help="fused binned kernels vs DGL-style baseline "
                        "(naive is not ported yet)")
    p.add_argument("--device", type=str, default="cuda")
    return p


if __name__ == "__main__":
    run(parser().parse_args())
