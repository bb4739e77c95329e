"""The sharded trainers, one rank of each: what ``run_ranks`` starts on
each rank of a process group (scripts/shard_scaling_torch.py,
chip_smoke.py); and ``spec_grads`` / ``dgcnn_grads``, one sharded model's
output and summed gradients on a rank, which the comparisons with a
single-device model run.

Graph models (``train_gat_rank``, ``train_monet_rank``; the JAX
package's sharded GAT and MoNet steps, ``__graft_entry__.py``): each rank
holds its shard's view of a partitioned graph, the same initial weights
(every rank seeds the same generator) and, for GAT, the same attention
seeds a step (one seed generator, the same on every rank); feature dropout
draws from the rank's own generator.  A step: the rank's share of the
masked cross entropy (its training rows' terms over the global
training-row count), ``backward()``, ``allreduce_grads`` (a SUM), then the
same Adam step on every rank, so the ranks' weights stay equal.

DGCNN (``train_dgcnn_rank``; the JAX package's batch-data-parallel step):
every rank draws each epoch's permutation and augmentation of the whole
training set, and the dropout, from one device generator seeded the same
on every rank, and takes its contiguous B/P clouds of each step's batch of
B, so at P = 1 the steps are the DGCNN trainer's epoch
(scripts/train_edgeconv_torch.py ``make_epoch``) and at P ranks the same
steps up to float32 summation order.  A step: the rank's share of the
smoothed cross entropy (its clouds' terms over B), ``backward()`` (the
batch norm's statistics summed over the ranks in both passes,
``GlobalBatchNorm``), ``allreduce_grads``, and the same ``SGDCosine`` step
on every rank.

Every step is issued from the host: gloo's collectives cannot be captured
into a CUDA graph.  Each trainer returns the same record
(``_timed_steps``): the rank's losses (its shares: their sum over the
ranks is the loss), seconds a step, peak device MB, kernel launches (every
wrapper's counter), and the halo exchanges' and all-reduces' counts, bytes
and route.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from .. import ops
from ..ops.gmm import NodePseudo
from ..utils.timing import (device_peak_memory_mb, reset_peak_memory,
                            time_calls)
from ..utils.training import (make_optimizer, make_sgd_cosine,
                              shuffle_augment, smoothed_loss)
from .partition import GraphShards, shard_view
from .spmd import (ALLREDUCES, EXCHANGES, ShardedDGCNN, ShardedGAT,
                   ShardedMoNet, allreduce_grads, reset_exchanges,
                   shard_edge_data)

__all__ = ["GATJob", "MoNetJob", "DGCNNJob", "train_gat_rank",
           "train_monet_rank", "train_dgcnn_rank", "train_rank",
           "shard_rows", "shard_loss", "dgcnn_share", "degree_pseudo",
           "state_digest", "spec_grads", "dgcnn_grads", "LR", "MONET_LR"]

LR = 1e-3  # Adam's learning rate, the JAX bench's for GAT
MONET_LR = 1e-2  # Adam's learning rate of the MoNet CLI and bench


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


def _timed_steps(step, device, steps: int, warmup: int) -> dict:
    """Run ``step`` ``warmup`` times, then ``steps`` times timed
    (``time_calls``), with every launch counter, the collectives' counters
    and the peak memory set to 0 just before; returns the record the
    trainers share: seconds a step, peak device MB, the launches of the
    wrappers that launched, the exchanges and the all-reduces."""
    ops.reset_all_launches()
    reset_exchanges()
    reset_peak_memory(device)
    step_s = time_calls(step, device, iters=steps, warmup=warmup)
    return dict(step_s=step_s, peak_mb=device_peak_memory_mb(device),
                launches={k: v for k, v in ops.all_launches().items() if v},
                exchanges=dict(EXCHANGES), allreduces=dict(ALLREDUCES))


def _node_task(job, rank: int, device):
    """A graph job's shard on ``rank``: (its view, its rows' features,
    labels and training mask, the graph's training-row count)."""
    view = shard_view(job.shards, rank, device)

    def rows(x):
        return torch.from_numpy(shard_rows(x, view)).to(device)

    return (view, rows(job.features), rows(job.labels.astype(np.int64)),
            rows(job.train_mask), float(job.train_mask.sum()))


def _check_world(job, world: int) -> None:
    if job.shards.num_shards != world:
        raise ValueError(f"{job.shards.num_shards} shards for {world} ranks")


def train_gat_rank(rank: int, world: int, job: GATJob) -> dict:
    """Train ``job`` on shard ``rank`` of ``world`` (the process group is
    formed).  Returns ``_timed_steps``' record, the rank's losses and its
    rows' logits after training (eval mode)."""
    _check_world(job, world)
    device = torch.device(job.device)
    view, feats, labels, mask, n_train = _node_task(job, rank, device)
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

    record = _timed_steps(step, device, job.steps, job.warmup)
    model.eval()
    with torch.no_grad():
        logits = model(view, feats)
    return dict(record, losses=[float(x) for x in losses],
                logits=logits.cpu().numpy())


@dataclasses.dataclass
class MoNetJob:
    """A sharded MoNet training run with node pseudo-coordinates: the
    partitioned graph, the node task and its pseudo column, the model
    (MoNet's CLI widths) and the steps."""

    shards: GraphShards
    features: np.ndarray      # [N, F] float32
    labels: np.ndarray        # [N] int
    train_mask: np.ndarray    # [N] bool
    pseudo: np.ndarray        # [N, 1] float32, both endpoints' (degree_pseudo)
    n_classes: int
    n_hidden: int = 64
    n_kernels: int = 3
    dim: int = 2
    dropout: float = 0.5
    weight_decay: float = 5e-4
    steps: int = 20           # timed steps, after ``warmup`` more
    warmup: int = 3
    dense_dtype: str = "bfloat16"
    device: str = "cuda"


def degree_pseudo(dst: np.ndarray, n: int) -> np.ndarray:
    """Each node's 1 / sqrt(max(in-degree, 1)) over the edge list's
    destinations, [n, 1] float32: the node pseudo-coordinate of the JAX
    package's sharded MoNet step (``__graft_entry__.py``), on both ends of
    an edge."""
    deg = np.maximum(np.bincount(dst, minlength=n), 1).astype(np.float32)
    return (1.0 / np.sqrt(deg))[:, None]


def train_monet_rank(rank: int, world: int, job: MoNetJob) -> dict:
    """Train ``job`` (one hidden layer) on shard ``rank`` of ``world``, Adam
    at ``MONET_LR``; returns what ``train_gat_rank`` returns."""
    _check_world(job, world)
    device = torch.device(job.device)
    view, feats, labels, mask, n_train = _node_task(job, rank, device)
    ps = torch.from_numpy(shard_rows(job.pseudo, view)).to(device)
    pseudo = NodePseudo(src=ps, dst=ps)
    model = ShardedMoNet(job.features.shape[1], job.n_hidden, job.n_classes,
                         1, job.dim, job.n_kernels, dropout=job.dropout,
                         dense_dtype=job.dense_dtype,
                         generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    opt = make_optimizer(model, MONET_LR, job.weight_decay)
    drop_gen = torch.Generator(device=device).manual_seed(rank)
    losses = []

    def step():
        model.train()
        opt.zero_grad(set_to_none=True)
        logits = model(view, feats, pseudo, generator=drop_gen)
        loss = shard_loss(logits, labels, mask, n_train)
        loss.backward()
        allreduce_grads(model)
        opt.step()
        losses.append(loss.detach())

    record = _timed_steps(step, device, job.steps, job.warmup)
    model.eval()
    with torch.no_grad():
        logits = model(view, feats, pseudo)
    return dict(record, losses=[float(x) for x in losses],
                logits=logits.cpu().numpy())


@dataclasses.dataclass
class DGCNNJob:
    """A batch-data-parallel DGCNN training run: the training clouds, the
    model (the DGCNN trainer's widths by default) and the steps."""

    x_train: np.ndarray       # [S, P, 3] float32 clouds
    y_train: np.ndarray       # [S] int labels
    n_classes: int
    batch_size: int = 64      # clouds a step, over all ranks
    k: int = 40
    feature_dims: tuple = (64, 64, 128, 256)
    emb_dims: tuple = (512, 512, 256)
    dropout: float = 0.5
    steps: int = 20           # timed steps, after ``warmup`` more
    warmup: int = 3
    seed: int = 0             # the init's and the device generator's seed
    state: dict | None = None  # initial state_dict; None: the seed's init
    device: str = "cuda"


def dgcnn_share(logits, labels, batch: int) -> torch.Tensor:
    """A rank's share of the smoothed cross entropy of a batch of ``batch``
    clouds: its clouds' terms over ``batch``, so the ranks' shares sum to
    the loss (on one device, the loss itself)."""
    return smoothed_loss(logits, labels) * (logits.shape[0] / batch)


def state_digest(module: torch.nn.Module) -> str:
    """SHA-256 of every parameter and buffer (names and bytes, in
    ``state_dict`` order): equal digests mean equal bits."""
    h = hashlib.sha256()
    for name, v in module.state_dict().items():
        h.update(name.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_dgcnn_rank(rank: int, world: int, job: DGCNNJob) -> dict:
    """Train ``job`` batch-data-parallel as rank ``rank`` of ``world`` (the
    process group is formed; ``world`` divides the batch): ``warmup`` +
    ``steps`` steps through as many epochs of ``len(x_train) //
    batch_size`` steps as they take, ``SGDCosine`` decaying over them.
    Returns ``_timed_steps``' record, the rank's losses, and its final
    parameters and batch-norm statistics (``state``, on the host) with
    their ``digest``, which must be the same on every rank."""
    if job.batch_size % world:
        raise ValueError(f"a batch of {job.batch_size} for {world} ranks")
    b = job.batch_size // world
    device = torch.device(job.device)
    model = ShardedDGCNN(k=job.k, feature_dims=job.feature_dims,
                         emb_dims=job.emb_dims, output_classes=job.n_classes,
                         dropout=job.dropout,
                         generator=torch.Generator().manual_seed(job.seed))
    if job.state is not None:
        model.load_state_dict(job.state, strict=True)
    model = model.to(device)
    opt = make_sgd_cosine(model, job.warmup + job.steps)
    per_epoch = len(job.x_train) // job.batch_size
    if per_epoch < 1:
        raise ValueError(f"{len(job.x_train)} clouds in batches of "
                         f"{job.batch_size}: no step")
    n = per_epoch * job.batch_size
    x = torch.from_numpy(job.x_train[:n]).to(device)
    y = torch.from_numpy(job.y_train[:n].astype(np.int64)).to(device)
    gen = torch.Generator(device=device).manual_seed(job.seed)
    losses, epoch = [], {}

    def step():
        i = len(losses) % per_epoch
        if i == 0:
            epoch["x"], epoch["y"] = shuffle_augment(x, y, gen)
        lo = i * job.batch_size + rank * b
        model.train()
        opt.zero_grad(set_to_none=True)
        logits = model(epoch["x"][lo:lo + b], generator=gen)
        loss = dgcnn_share(logits, epoch["y"][lo:lo + b], job.batch_size)
        loss.backward()
        allreduce_grads(model)
        opt.step()
        losses.append(loss.detach())

    record = _timed_steps(step, device, job.steps, job.warmup)
    return dict(record, losses=[float(v) for v in losses],
                digest=state_digest(model),
                state={k: v.cpu() for k, v in model.state_dict().items()})


def dgcnn_grads(spec: dict, rank: int, world: int, device="cuda") -> dict:
    """One training forward and backward of ShardedDGCNN as rank ``rank``
    of ``world`` (the process group is formed): built from ``spec``
    ("kwargs" for DGCNN, "state"), run on the rank's B/P clouds of "x"
    [B, P, 3] with a device generator seeded "seed" drawing the dropout,
    its share of the smoothed cross entropy of "y" back-propagated and the
    gradients summed over the ranks.  Returns its clouds' "logits", its
    "loss" share, the summed "grads" {parameter name: gradient} and the
    batch norms' running statistics after the pass ("stats", {buffer name
    under ``bns``: tensor})."""
    device = torch.device(device)
    model = ShardedDGCNN(**spec["kwargs"])
    model.load_state_dict(spec["state"], strict=True)
    model = model.to(device).train()
    batch = spec["x"].shape[0]
    b = batch // world
    rows = slice(rank * b, (rank + 1) * b)
    x = torch.from_numpy(spec["x"][rows]).to(device)
    y = torch.from_numpy(spec["y"][rows].astype(np.int64)).to(device)
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    logits = model(x, generator=gen)
    loss = dgcnn_share(logits, y, batch)
    loss.backward()
    allreduce_grads(model)
    return dict(logits=logits.detach(), loss=loss.detach(),
                grads={k: p.grad for k, p in model.named_parameters()},
                stats=dict(model.bns.named_buffers()))


_TRAINERS = {GATJob: train_gat_rank, MoNetJob: train_monet_rank,
             DGCNNJob: train_dgcnn_rank}


def train_rank(rank: int, world: int, job) -> dict:
    """Train any job (GATJob, MoNetJob, DGCNNJob) as rank ``rank``."""
    return _TRAINERS[type(job)](rank, world, job)
