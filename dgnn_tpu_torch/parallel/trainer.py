"""Sharded GAT training, one rank of it: what ``run_ranks`` starts on each
rank of a process group (scripts/shard_scaling_torch.py, chip_smoke.py);
and ``spec_grads``, one sharded model's output and summed gradients on a
rank, which the comparisons with a single-device model run.

Each rank holds its shard's view of a partitioned graph, the same initial
weights (every rank seeds the same generator) and the same attention
seeds a step (one seed generator, the same on every rank); feature
dropout draws from the rank's own generator.  A step: the rank's share of
the masked cross entropy (its training rows' terms over the global
training-row count), ``backward()``, ``allreduce_grads`` (a SUM), then the
same Adam step on every rank, so the ranks' weights stay equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import bins, dense
from ..ops.gmm import NodePseudo
from ..utils.timing import (device_peak_memory_mb, reset_peak_memory,
                            time_calls)
from ..utils.training import make_optimizer
from .partition import GraphShards, shard_view
from .spmd import (EXCHANGES, ShardedGAT, ShardedMoNet, allreduce_grads,
                   reset_exchanges, shard_edge_data)

__all__ = ["GATJob", "train_gat_rank", "shard_rows", "shard_loss",
           "spec_grads", "LR"]

LR = 1e-3  # Adam's learning rate, the JAX bench's for GAT


@dataclasses.dataclass
class GATJob:
    """A sharded GAT training run: the partitioned graph, the node task
    (padded to the shards' node count, or not), the model and the steps."""

    shards: GraphShards
    features: np.ndarray      # [N, F] float32
    labels: np.ndarray        # [N] int
    train_mask: np.ndarray    # [N] bool
    n_classes: int
    n_hidden: int = 64
    heads: tuple = (4, 1)
    feat_drop: float = 0.5
    attn_drop: float = 0.3
    weight_decay: float = 5e-4
    steps: int = 20           # timed steps, after ``warmup`` more
    warmup: int = 3
    dense_dtype: str = "bfloat16"
    device: str = "cuda"


def shard_rows(x: np.ndarray, view) -> np.ndarray:
    """A shard's rows of a node table (ShardView.rows), zero rows past the
    table's end (the last shard's padding)."""
    out = np.zeros((view.nodes_per_shard,) + x.shape[1:], x.dtype)
    part = x[view.rows]
    out[:len(part)] = part
    return out


def shard_loss(logits, labels, mask, n_train: float) -> torch.Tensor:
    """A rank's share of the masked cross entropy: its training rows' terms
    over ``n_train``, the whole graph's training-row count, so the ranks'
    shares sum to the loss (on one device, the loss itself)."""
    ls = torch.nn.functional.cross_entropy(logits, labels, reduction="none")
    return (ls * mask).sum() / n_train


def spec_grads(spec: dict, rank: int, loss, device="cuda"):
    """One sharded model on shard ``rank`` (the process group is formed):
    built from ``spec`` ("model": "gat" or "monet", its "kwargs" and
    "state", "training", "seeds" (attention seeds a layer, or None),
    "shards", "features" [N, F]; for MoNet "pseudo": "node" with "psrc" and
    "pdst" [N, D], or "binned" with "pseudo_flat" [E, D] in the unsharded
    graph's CSR order), run on the shard's rows, ``loss(out, rows)``
    back-propagated (``rows(x)``: the shard's rows of a node table, on the
    device) and the gradients summed over the ranks.  Returns (the output
    of the shard's rows, {parameter name: summed gradient})."""
    device = torch.device(device)
    view = shard_view(spec["shards"], rank, device)
    cls = ShardedGAT if spec["model"] == "gat" else ShardedMoNet
    model = cls(**spec["kwargs"])
    model.load_state_dict(spec["state"], strict=True)
    model = model.to(device).train(spec["training"])

    def rows(x):
        return torch.from_numpy(shard_rows(x, view)).to(device)

    args = ()
    if spec.get("pseudo") == "node":
        args = (NodePseudo(src=rows(spec["psrc"]), dst=rows(spec["pdst"])),)
    elif spec.get("pseudo") == "binned":
        args = (shard_edge_data(
            view, torch.from_numpy(spec["pseudo_flat"]).to(device)),)
    kw = {} if spec.get("seeds") is None else dict(attn_seeds=spec["seeds"])
    out = model(view, rows(spec["features"]), *args, **kw)
    loss(out, rows).backward()
    allreduce_grads(model)
    return out.detach(), {k: p.grad for k, p in model.named_parameters()}


def train_gat_rank(rank: int, world: int, job: GATJob) -> dict:
    """Train ``job`` on shard ``rank`` of ``world`` (the process group is
    formed).  Returns the rank's losses (its shares: their sum over the
    ranks is the loss), seconds a step, peak device MB, kernel launches
    (every bin and hub-block wrapper), the halo exchanges' count, bytes
    and route, and its rows' logits after training (eval mode)."""
    if job.shards.num_shards != world:
        raise ValueError(f"{job.shards.num_shards} shards for {world} ranks")
    device = torch.device(job.device)
    view = shard_view(job.shards, rank, device)
    feats = torch.from_numpy(shard_rows(job.features, view)).to(device)
    labels = torch.from_numpy(shard_rows(job.labels.astype(np.int64),
                                         view)).to(device)
    mask = torch.from_numpy(shard_rows(job.train_mask, view)).to(device)
    n_train = float(job.train_mask.sum())
    n_layers = len(job.heads) - 1
    model = ShardedGAT(job.features.shape[1], n_layers, job.n_hidden,
                       job.n_classes, job.heads, feat_drop=job.feat_drop,
                       attn_drop=job.attn_drop, dense_dtype=job.dense_dtype,
                       generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    opt = make_optimizer(model, LR, job.weight_decay)
    drop_gen = torch.Generator(device=device).manual_seed(rank)
    seed_gen = torch.Generator().manual_seed(1)
    losses = []

    def step():
        seeds = torch.randint(0, 2 ** 32, (len(model.convs),),
                              generator=seed_gen, dtype=torch.int64).tolist()
        model.train()
        opt.zero_grad(set_to_none=True)
        logits = model(view, feats, generator=drop_gen, attn_seeds=seeds)
        loss = shard_loss(logits, labels, mask, n_train)
        loss.backward()
        allreduce_grads(model)
        opt.step()
        losses.append(loss.detach())

    bins.reset_launches()
    dense.reset_launches()
    reset_exchanges()
    reset_peak_memory(device)
    step_s = time_calls(step, device, iters=job.steps, warmup=job.warmup)
    launches = {**{k: v for k, v in bins.LAUNCHES.items() if v},
                **{k: v for k, v in dense.LAUNCHES.items() if v}}
    exchanges = dict(EXCHANGES)
    peak = device_peak_memory_mb(device)
    model.eval()
    with torch.no_grad():
        logits = model(view, feats)
    return dict(losses=[float(x) for x in losses], step_s=step_s,
                peak_mb=peak, launches=launches, exchanges=exchanges,
                logits=logits.cpu().numpy())
