#!/usr/bin/env python
"""MoNet (GMMConv) training CLI for the PyTorch port (counterpart of
scripts/train_gmm.py).

Same flags and defaults as scripts/train_gmm.py, plus ``--device`` (default
``cuda``), ``--pseudo``, ``--scale`` and ``--cache-dir``.  The pseudo of edge (u -> v) is [1/sqrt(deg_u),
1/sqrt(deg_v)] over in-degrees clamped at 1, in one of two forms:

- binned (the JAX CLI's on the citation graphs, ``scripts/train_gmm.py``
  :66-74, and this CLI's default there): the graph is built with no hub
  block and with edge tables, and the per-edge pseudo is pre-binned into
  both directions' slot tables (``bin_pseudo``); its passes are plain
  PyTorch (the JAX package's are XLA, no Pallas kernel);
- node (``--pseudo node``, every gmm configuration of the JAX bench, and
  the default on reddit as in the JAX CLI): per-node columns
  (``NodePseudo``) projected inside the fused op, on a graph built with
  ``dense="auto"``, through the bin and hub-block kernels.

``--dataset reddit`` takes the JAX CLI's reddit protocol
(``scripts/train_gmm.py:40-64``): the R-MAT graph at reddit's size (cut by
``--scale``, as bench.py's scale), read from the port's cache under
``--cache-dir`` or built and cached there (dgnn_tpu_torch/data/reddit.py),
its task derived from its own edges, node pseudo, and bf16 feature gathers
(float32 on the citation graphs, as the JAX CLI).

Same loss (masked mean cross-entropy over ``train_mask``) and optimizer
(Adam with coupled L2 weight decay, which is what
``optax.add_decayed_weights`` + ``optax.adam`` compute).  Prints train and
inference seconds per epoch, peak device memory and test accuracy, and
appends one CSV row named ``train_GMM_dgnn_tpu_torch``.

It trains and times as the JAX CLI does (``scripts/train_gmm.py:104-130``),
with the JAX package's device-resident loop ported as a replayed CUDA graph
(dgnn_tpu_torch/utils/timing.py): training is timed by ``time_epoch_loop``
on a throwaway copy of the model and optimizer state; the model then trains
exactly ``--n-epochs`` steps from its initial state by ``run_epochs`` (one
capture, ``--n-epochs`` replays), for the accuracy; inference is timed by
``time_epoch_loop`` over a no-grad forward.  Each step draws its feature
dropout on the device from a generator seeded by ``--seed``, so every
replay draws new masks; the losses go to a device buffer, read once at the
end.  ``--device cpu`` runs the same protocol in host loops.  With node
pseudo the
graph is built with ``dense="auto"``: on cora, citeseer and reddit the hub
planner keeps a dense block, which the dense hub-block kernels take, and
the rest of the edges go through the degree bins.

    python scripts/train_gmm_torch.py --dataset cora --n-hidden 64 \
        --n-kernels 3 --pseudo-dim 2 --n-epochs 20 [--pseudo node]
    python scripts/train_gmm_torch.py --dataset reddit --n-hidden 64 \
        --n-kernels 2 --pseudo-dim 2 --n-epochs 5 [--scale 0.25]
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
from dgnn_tpu_torch.models import MoNet
from dgnn_tpu_torch.ops.gmm import NodePseudo, bin_pseudo
from dgnn_tpu_torch.utils import (append_csv_row, device_peak_memory_mb,
                                  make_optimizer, masked_loss,
                                  reset_peak_memory, run_epochs,
                                  time_epoch_loop)

# eager steps before a timing loop's capture
WARMUP_STEPS = 3
# The JAX bench's gmm_* configurations on the citation graphs (bench.py):
# node pseudo at their width, what the card smoke run and
# scripts/profile_step_torch.py train at.
BENCH_ARGV = ["--n-hidden", "64", "--n-kernels", "3", "--pseudo-dim", "2",
              "--n-layers", "1", "--dropout", "0.5", "--lr", "1e-2",
              "--pseudo", "node"]


def node_pseudo(graph) -> NodePseudo:
    """1 / sqrt(max(in-degree, 1)) as an [N, 1] column for both endpoints.
    Needs the raw CSR, so call it before ``graph.slim()``."""
    deg = graph.in_degrees().to(torch.float32).clamp(min=1.0)
    rsq = torch.rsqrt(deg)[:, None]
    return NodePseudo(src=rsq, dst=rsq)


def edge_pseudo(graph):
    """[E, 2] pseudo-coordinates in CSR edge order: [1/sqrt(deg_u),
    1/sqrt(deg_v)] over in-degrees clamped at 1 (scripts/train_gmm.py:27).
    Needs the raw CSR, so call it before ``graph.slim()``."""
    rsq = torch.rsqrt(graph.in_degrees().to(torch.float32).clamp(min=1.0))
    row = torch.repeat_interleave(torch.arange(graph.num_nodes),
                                  torch.diff(graph.row_ptr).long())
    return torch.stack([rsq[graph.col_ind.long()], rsq[row]], dim=1)


def setup(args):
    """Graph, pseudo-coordinates (CPU) and task as the CLI builds them:
    (graph, pseudo, mode, gather_dtype, features, labels, train_mask,
    test_mask, n_classes, host set-up seconds by stage, host peak resident
    MB or None)."""
    reddit = args.dataset == "reddit"
    mode = args.pseudo or ("node" if reddit else "binned")
    gather = "bfloat16" if reddit else "float32"
    if reddit:
        if mode != "node":
            raise ValueError("--dataset reddit takes node pseudo (its graph "
                             "is cached without edge tables)")
        rd = load_reddit(args.scale, seed=args.seed, cache_dir=args.cache_dir)
        graph, seconds, peak = rd.graph, rd.seconds, rd.host_peak_mb
        print(f"reddit scale {args.scale}: host set-up {seconds}, host peak "
              f"RSS {peak:.0f} MB")
        feats, labels, n_classes = rd.features, rd.labels, rd.n_classes
        train_mask, test_mask = rd.train_mask, rd.test_mask
    else:
        data = load_citation_dataset(args.dataset, seed=args.seed)
        # binned: the JAX CLI's build_graph defaults (no hub block, edge
        # tables); node: the bench's
        kw = (dict(dense=None, edge_tables=True) if mode == "binned"
              else dict(dense="auto", edge_tables=False))
        graph = build_graph(data.src, data.dst, data.num_nodes, **kw)
        seconds, peak = {}, None
        feats, labels, n_classes = data.features, data.labels, data.n_classes
        train_mask, test_mask = data.train_mask, data.test_mask
    pseudo = (bin_pseudo(graph, edge_pseudo(graph)) if mode == "binned"
              else node_pseudo(graph))
    return (graph.slim(), pseudo, mode, gather, feats, labels, train_mask,
            test_mask, n_classes, seconds, peak)


def _to(pseudo, device):
    """A pseudo argument of either mode on ``device``."""
    if isinstance(pseudo, torch.Tensor):
        return pseudo.to(device)
    moved = [_to(p, device) for p in pseudo]
    return NodePseudo(*moved) if isinstance(pseudo, NodePseudo) \
        else tuple(moved)


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


def make_step(model, opt, graph, feats, pseudo, labels, train_mask, gen,
              count, losses=None):
    """One training step as ``time_epoch_loop`` and ``run_epochs`` take it:
    it steps with feature dropout from ``gen`` (on the device), writes the
    loss to ``losses[count]`` (a device buffer, where given) and adds one
    to ``count`` (a [1] int64 device tensor)."""

    def step():
        loss = train_step(model, opt, graph, feats, pseudo, labels,
                          train_mask, gen)
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

    (graph, pseudo, mode, gather, feats, labels, train_mask, test_mask,
     n_classes, setup_s, host_peak_mb) = setup(args)
    graph = graph.to(device)
    pseudo = _to(pseudo, device)
    feats = torch.from_numpy(feats).to(device)
    labels = torch.from_numpy(labels).long().to(device)
    train_mask = torch.from_numpy(train_mask).to(device)
    test_mask = torch.from_numpy(test_mask).to(device)

    model = MoNet(feats.shape[1], args.n_hidden, n_classes,
                  args.n_layers, args.pseudo_dim, args.n_kernels,
                  dropout=args.dropout, pseudo=mode, gather_dtype=gather,
                  generator=torch.Generator().manual_seed(args.seed)
                  ).to(device)
    opt = make_optimizer(model, args.lr, args.weight_decay)
    task = (graph, feats, pseudo, labels, train_mask)

    def counter():
        return torch.zeros(1, dtype=torch.int64, device=device)

    def drop_gen():
        return torch.Generator(device=device).manual_seed(args.seed)

    print(args)
    print("profile training")
    # timing on a throwaway copy of the model and optimizer state; the
    # accuracy from EXACTLY n_epochs steps below (the timing loop runs
    # many more: utils.timing.run_epochs)
    model_t = copy.deepcopy(model)
    gen_t, timed = drop_gen(), counter()
    train_s = time_epoch_loop(
        make_step(model_t, make_optimizer(model_t, args.lr,
                                          args.weight_decay),
                  *task, gen_t, timed),
        args.n_epochs, device=device, warmup=WARMUP_STEPS,
        generators=(gen_t,))
    del model_t
    gen, done = drop_gen(), counter()
    losses = torch.zeros(args.n_epochs, device=device)
    reset_peak_memory(device)
    run_epochs(make_step(model, opt, *task, gen, done, losses),
               args.n_epochs, device=device, generators=(gen,))
    max_mb = device_peak_memory_mb(device)
    losses = losses.tolist()

    print("profile inference")
    model.eval()
    calls = counter()

    def infer():
        with torch.no_grad():
            model(graph, feats, pseudo)
        calls.add_(1)

    infer_s = time_epoch_loop(infer, args.n_epochs, device=device,
                              warmup=WARMUP_STEPS)
    with torch.no_grad():
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
                train_steps=int(timed) + int(done),
                infer_calls=int(calls) + 1,
                model=model, graph=graph, feats=feats, pseudo=pseudo,
                pseudo_mode=mode, gather_dtype=gather, setup_s=setup_s,
                host_peak_mb=host_peak_mb,
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
    p.add_argument("--pseudo", type=str, default=None,
                   choices=["node", "binned"],
                   help="node-derived pseudo-coordinates (the bench's) or "
                        "pre-binned per-edge tables; default: the JAX "
                        "CLI's, binned on the citation graphs, node on "
                        "reddit")
    p.add_argument("--scale", type=float, default=1.0,
                   help="reddit only: nodes and edges times this")
    p.add_argument("--cache-dir", type=str, default=None,
                   help="reddit only: where the host build is cached "
                        "(default: .bench_cache at the checkout's root)")
    p.add_argument("--device", type=str, default="cuda")
    return p


if __name__ == "__main__":
    run(parser().parse_args())
