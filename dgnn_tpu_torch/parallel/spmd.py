"""Row-partitioned GNN layers, one process a shard, on ``torch.distributed``.

Port of ``dgnn_tpu/parallel/spmd.py``.  Node features live sharded by row
range (parallel/partition.py); each layer sends exactly the planned
boundary rows with ONE all-to-all (``halo_exchange``) and then runs the
single-device fused op over the shard's bipartite layout: destinations are
its C rows, sources its rows and the halo rows it received.  The exchange's
backward is the same all-to-all of the halo rows' gradients, added into the
rows they came from, so remote feature gradients return to their owning
shard.

Where the JAX package runs every shard in one ``shard_map`` program and
``psum_grad`` sums the replicated parameters' gradients across shards, here
each rank computes its own shard's loss share (its rows' terms under the
global normaliser) and ``allreduce_grads`` SUMS every parameter gradient
across the ranks after ``backward()`` (a SUM, not DDP's average).

The models keep the single-device modules' parameter names (they are
built from the same GATConv / GMMConv layers), so a single-device
``state_dict``, and ``models.load_flax_gat`` / ``load_flax_monet``, load
into them strictly.  Attention dropout hashes global node ids
(``ShardView.ext_gids``), so a shard's mask is the single-device one bit
for bit; feature dropout draws from each rank's own ``torch.Generator``
(the JAX package's per-shard feature mask is not the single-device one
either).

Batch data parallelism (``ShardedDGCNN``): each rank runs DGCNN on its
contiguous B/P clouds of every batch.  Its batch norm takes the mean and
variance over the GLOBAL batch (``GlobalBatchNorm``: one differentiable
all-reduce of the local sums), as flax's BatchNorm does under ``jit`` on
a batch sharded over a mesh, and its feature dropout draws the global
batch's mask from a generator seeded the same on every rank and takes the
rank's rows, so that a P-rank step is the single-device step up to float32
summation order, dropout on.  That is unlike the graph models' feature
dropout above, which draws from each rank's own generator.

Exchange routes.  Every collective hands its tensors to the process
group's backend as they are: NCCL on CUDA tensors, gloo on CPU tensors and
on CUDA tensors too (P ranks sharing one card, where NCCL refuses a card
shared by ranks): the installed torch's gloo takes CUDA tensors for
all_to_all_single and all_reduce and copies them through the host itself
(checked on an H100 with torch 2.11).  ``EXCHANGES`` counts the exchanges,
the bytes they sent and their route ("<backend>/<device type>");
``ALLREDUCES`` the all-reduces (the gradient sums and the batch norm's
statistics, forward and backward) the same way.
"""

from __future__ import annotations

import dataclasses
import typing

import torch
import torch.distributed as dist
from torch import nn

from ..models.dgcnn import DGCNN, BatchNorm
from ..models.gat import GATConv, _dropout
from ..models.monet import GMMConv, _mode_of
from ..ops.gat import gat_fused
from ..ops.gmm import gmm_binned_fused, gmm_node_fused
from .partition import ShardView, merge_binned

__all__ = ["halo_exchange", "merge_binned", "shard_edge_data",
           "allreduce_grads", "exchange_route", "batch_parallel",
           "ShardedGATConv", "ShardedGAT", "ShardedGMMConv", "ShardedMoNet",
           "GlobalBatchNorm", "ShardedDGCNN", "EXCHANGES", "ALLREDUCES",
           "reset_exchanges"]

EXCHANGES = {"exchanges": 0, "bytes": 0, "route": None}
ALLREDUCES = {"allreduces": 0, "bytes": 0, "route": None}


def reset_exchanges() -> None:
    """Set ``EXCHANGES`` and ``ALLREDUCES`` to 0."""
    EXCHANGES.update(exchanges=0, bytes=0, route=None)
    ALLREDUCES.update(allreduces=0, bytes=0, route=None)


def exchange_route(t: torch.Tensor, group=None) -> str:
    """The route a collective on ``t`` takes: "<backend>/<device type>",
    e.g. "gloo/cuda" (module docstring)."""
    return f"{dist.get_backend(group)}/{t.device.type}"


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """Equal-split all-to-all of ``send``'s rows (P blocks of equal size):
    block q goes to rank q, block q of the result came from rank q."""
    send = send.contiguous()
    EXCHANGES["exchanges"] += 1
    EXCHANGES["bytes"] += send.numel() * send.element_size()
    EXCHANGES["route"] = exchange_route(send, group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """SUM ``t`` over the ranks in place, counted in ``ALLREDUCES``."""
    ALLREDUCES["allreduces"] += 1
    ALLREDUCES["bytes"] += t.numel() * t.element_size()
    ALLREDUCES["route"] = exchange_route(t, group)
    dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks; its backward sums the gradient over
    the ranks too (every rank's loss share reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _HaloExchange(torch.autograd.Function):
    """x_local [C, D] -> [C + P*Hmax, D]: the shard's rows, then the halo
    rows block by block (block q from rank q, in q's send order)."""

    @staticmethod
    def forward(ctx, x_local, send_ids, group):
        flat = send_ids.reshape(-1).long()
        recv = _all_to_all(x_local.index_select(0, flat), group)
        ctx.save_for_backward(flat)
        ctx.group, ctx.rows = group, x_local.shape[0]
        return torch.cat([x_local, recv], 0)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        # the halo rows' gradients go back to the ranks that sent the rows,
        # and are added into the rows they were read from
        back = _all_to_all(g[ctx.rows:], ctx.group)
        d_local = g[:ctx.rows].clone().index_add_(0, flat, back)
        return d_local, None, None


def halo_exchange(x_local: torch.Tensor, send_ids: torch.Tensor, group=None):
    """Exchange boundary rows: returns [C + P*Hmax, D] extended features.

    x_local: [C, D] this shard's rows; send_ids: [P, Hmax] local row ids to
    send to each peer (ShardView.send_ids).  The rows of peer q arrive in
    exactly this shard's halo-slot order (partition.py builds both sides
    from the same sorted request list), so extended id C + q*Hmax + j is
    the j-th row received from q.  Differentiable in x_local."""
    return _HaloExchange.apply(x_local, send_ids, group)


def allreduce_grads(module: nn.Module, group=None) -> None:
    """SUM every parameter's gradient over the ranks, in one collective
    (parameters without a gradient take part as zeros).  Call after
    ``backward()`` of each rank's share of the loss."""
    params = [p for p in module.parameters() if p.requires_grad]
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    _all_reduce(flat, group)
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p).clone()
        off += n


def batch_parallel(model: nn.Module, x: torch.Tensor, group=None):
    """Batch data parallelism for a model whose samples are independent
    (DGCNN in eval mode: per-cloud k-NN graphs, batch norm on its running
    statistics): rank r runs ``model`` on its contiguous B/P of the batch
    ``x`` and the ranks' outputs are gathered in rank order, so every rank
    returns the whole batch's output, as ``tests/test_parallel.py:316``
    shards the batch over the mesh.  B must divide by the rank count."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if x.shape[0] % world:
        raise ValueError(f"a batch of {x.shape[0]} for {world} ranks")
    b = x.shape[0] // world
    local = model(x[rank * b:(rank + 1) * b]).contiguous()
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts)


class GlobalBatchNorm(BatchNorm):
    """models.dgcnn.BatchNorm over the global batch of a batch-data-parallel
    model: in training, each rank's sum and sum of squares over its rows
    (every axis but the last) are summed over the ranks by one
    differentiable all-reduce, and the mean and biased variance are taken
    over the global count, as BatchNorm takes them on the whole batch; so
    the output, the input gradient and the running statistics (the same on
    every rank) are the single-device ones.  In eval mode it reads the
    running statistics, with no collective.  Every rank must hold as many
    rows.  Parameters and buffers as BatchNorm's."""

    def __init__(self, num_features: int, *, group=None, **kw):
        super().__init__(num_features, **kw)
        self.group = group

    def batch_stats(self, x: torch.Tensor):
        axes = tuple(range(x.dim() - 1))
        count = x.numel() // x.shape[-1] * dist.get_world_size(self.group)
        sums = _AllReduceSum.apply(
            torch.stack([x.sum(dim=axes), (x * x).sum(dim=axes)]), self.group)
        mean = sums[0] / count
        return mean, (sums[1] / count - mean * mean).clamp(min=0.0)


class ShardedDGCNN(DGCNN):
    """DGCNN trained batch-data-parallel: rank r runs the model on its
    contiguous B/P clouds of a batch of B (the same on every rank), its
    ``bns`` are ``GlobalBatchNorm``s and its feature dropout draws the
    global [B, C] mask (``feature_dropout``).  DGCNN's arguments, parameter
    names and init, so a single-device ``state_dict`` and
    ``models.load_flax_dgcnn`` load into it strictly; ``group``: the
    process group of the ranks.  Each rank's loss share is its clouds'
    terms over B, and ``allreduce_grads`` sums the gradients."""

    def __init__(self, *args, group=None, **kw):
        super().__init__(*args, **kw)
        self.group = group
        self.bns = nn.ModuleDict({
            name: GlobalBatchNorm(bn.scale.numel(), momentum=bn.momentum,
                                  eps=bn.eps, group=group)
            for name, bn in self.bns.items()})

    def feature_dropout(self, h: torch.Tensor,
                        generator: torch.Generator | None) -> torch.Tensor:
        """Dropout of this rank's rows h [B/P, C] under the mask of the
        global batch [B, C], drawn whole on every rank from ``generator``
        (seeded the same on every rank), so the draws are the single-device
        model's and the ranks' generators stay in step."""
        if generator is None:
            raise ValueError("feature dropout in training needs a "
                             "torch.Generator")
        b, rank = h.shape[0], dist.get_rank(self.group)
        u = torch.rand((dist.get_world_size(self.group) * b,) + h.shape[1:],
                       generator=generator, device=h.device)
        return torch.where(u[rank * b:(rank + 1) * b] < 1.0 - self.dropout,
                           h / (1.0 - self.dropout), 0.0)


def shard_edge_data(view: ShardView, data: torch.Tensor):
    """Reshard flat per-edge data [E, ...] (the global CSR edge order of
    the graph ``partition_graph`` was given, after its self-loop handling)
    into the shard's slot tables: (forward tables, backward tables), one
    [S, W, ...] tensor a bin, the form ``gmm_binned_fused`` and
    ``ops.gmm.bin_pseudo`` give."""
    local_flat = data[view.edge_gids.long()]  # [Emax, ...] local edge order
    return (tuple(local_flat[e.long()] for e in view.fwd.edge),
            tuple(local_flat[e.long()] for e in view.bwd.edge))


class ShardedGATConv(GATConv):
    """GATConv over one graph shard: local dense projection, one all-to-all
    of (features ++ attn_col) boundary rows, the fused aggregation over the
    shard's local ++ halo bins and hub block.  Parameters as GATConv's."""

    def __init__(self, in_feats: int, out_feats: int, num_heads: int, *,
                 dense_dtype: str = "bfloat16", **kw):
        super().__init__(in_feats, out_feats, num_heads, impl="fused", **kw)
        self.dense_dtype = dense_dtype

    def forward(self, view: ShardView, feat: torch.Tensor, *, group=None,
                generator: torch.Generator | None = None,
                seed: int | None = None) -> torch.Tensor:
        h, f = self.num_heads, self.out_feats
        x = self.W(feat).reshape(-1, h, f)
        if self.training and self.feat_drop > 0.0:
            x = _dropout(x, self.feat_drop, generator)
        attn_row = (self.attn_l * x).sum(dim=-1)  # [C, H] local dst rows
        attn_col = (self.attn_r * x).sum(dim=-1)  # [C, H] local src rows
        # one collective for features + source coefficients
        payload = torch.cat([x.reshape(-1, h * f), attn_col], dim=1)
        ext = halo_exchange(payload, view.send_ids, group)
        feat_ext = ext[:, :h * f].reshape(-1, h, f)
        ac_ext = ext[:, h * f:]
        rst = gat_fused(view.fwd, view.bwd, attn_row, ac_ext, feat_ext,
                        negative_slope=self.negative_slope,
                        attn_drop=self.attn_drop, seed=seed,
                        training=self.training,
                        gather_dtype=self.gather_dtype,
                        dense_dtype=self.dense_dtype, gid=view.ext_gids)
        if self.residual:
            res = feat if self.res_fc is None else self.res_fc(feat)
            rst = rst + res.reshape(-1, h, f)
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        return rst


class ShardedGAT(nn.Module):
    """Multi-layer sharded GAT with the topology, parameter names and init
    order of models.GAT (``convs["gat_0"] ... convs["gat_out"]``)."""

    def __init__(self, in_feats: int, num_layers: int, n_hidden: int,
                 n_classes: int, heads: typing.Sequence[int], *,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2, residual: bool = False,
                 activation=None, gather_dtype=None,
                 dense_dtype: str = "bfloat16",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.attn_drop = attn_drop
        kw = dict(feat_drop=feat_drop, attn_drop=attn_drop,
                  negative_slope=negative_slope, gather_dtype=gather_dtype,
                  dense_dtype=dense_dtype, generator=generator)
        convs = {}
        dim = in_feats
        for layer in range(num_layers):
            convs[f"gat_{layer}"] = ShardedGATConv(
                dim, n_hidden, heads[layer], residual=residual,
                activation=activation, use_bias=layer > 0, **kw)
            dim = n_hidden * heads[layer]
        convs["gat_out"] = ShardedGATConv(dim, n_classes, heads[-1], **kw)
        self.convs = nn.ModuleDict(convs)

    def forward(self, view: ShardView, feat: torch.Tensor, *, group=None,
                generator: torch.Generator | None = None,
                attn_seeds: typing.Sequence[int] | None = None):
        """Logits [C, n_classes] of the shard's rows.  ``feat``: [C, in]
        the shard's rows; ``attn_seeds``: one uint32 seed a layer, the same
        on every rank (and the single-device model's seeds give its mask);
        ``generator``: this rank's feature-dropout draws."""
        if self.training and self.attn_drop > 0.0:
            if attn_seeds is None or len(attn_seeds) != len(self.convs):
                raise ValueError(f"attention dropout in training needs "
                                 f"{len(self.convs)} attn_seeds, one per layer")
        h = feat
        for i, (name, conv) in enumerate(self.convs.items()):
            seed = attn_seeds[i] if attn_seeds is not None else None
            h = conv(view, h, group=group, generator=generator, seed=seed)
            if name != "gat_out":
                h = h.reshape(h.shape[0], -1)
        return h.mean(dim=1)


class ShardedGMMConv(GMMConv):
    """GMMConv over one graph shard, with GMMConv's parameters.  Two pseudo
    modes, as the single-device layer dispatches:

    - ``NodePseudo`` (the shard's rows' scalars, [C, Ds] and [C, Dd]): the
      source scalars ride the halo payload with the features, so every
      extended source row carries its own; the node op runs with the hub
      block and the combine tables;
    - a (forward tables, backward tables) tuple from ``shard_edge_data``:
      per-edge pseudo with the bins (edge data is owned by the destination
      shard, so no per-edge exchange).  On shards built with a hub block,
      as in the JAX layer, the combine tables are dropped (they index the
      block's rows, which this op never produces) and the segments are
      summed by row; the block's edges hold no slot and are not read."""

    def __init__(self, in_feats: int, out_feats: int, dim: int,
                 n_kernels: int, *, dense_dtype: str = "bfloat16", **kw):
        super().__init__(in_feats, out_feats, dim, n_kernels, **kw)
        self.dense_dtype = dense_dtype

    def forward(self, view: ShardView, feat: torch.Tensor, pseudo, *,
                group=None) -> torch.Tensor:
        k, f = self.n_kernels, self.out_feats
        node_feat = self.fc(feat).reshape(-1, k * f)
        mode = _mode_of(pseudo)
        if self.pseudo_w is None or mode == "flat":
            raise ValueError("a sharded GMMConv takes node or binned pseudo "
                             "coordinates and its own projection")
        if mode == "node":
            payload = torch.cat([node_feat, pseudo.src.float()], dim=1)
            ext = halo_exchange(payload, view.send_ids, group)
            rst = gmm_node_fused(view.fwd, view.bwd,
                                 ext[:, :k * f].reshape(-1, k, f),
                                 ext[:, k * f:], pseudo.dst.float(), self.mu,
                                 self.inv_sigma, proj_weight=self.pseudo_w,
                                 proj_bias=self.pseudo_b, use_tanh=True,
                                 dense_dtype=self.dense_dtype,
                                 gather_dtype=self.gather_dtype)
        else:
            feat_ext = halo_exchange(node_feat, view.send_ids,
                                     group).reshape(-1, k, f)
            fwd, bwd = view.fwd, view.bwd
            if fwd.dense is not None:
                fwd = dataclasses.replace(fwd, cmb=None, dense=None)
            if bwd.dense is not None:
                bwd = dataclasses.replace(bwd, cmb=None, dense=None)
            rst = gmm_binned_fused(fwd, bwd, feat_ext, pseudo, self.mu,
                                   self.inv_sigma, proj_weight=self.pseudo_w,
                                   proj_bias=self.pseudo_b, use_tanh=True)
        rst = rst.sum(dim=1)  # sum over the kernels
        if self.residual:
            rst = rst + (feat if self.res_fc is None else self.res_fc(feat))
        if self.bias is not None:
            rst = rst + self.bias
        return rst


class ShardedMoNet(nn.Module):
    """Sharded MoNet with the topology, parameter names and init order of
    models.MoNet in its "node" and "binned" modes (``convs["gmm_<i>"]``)."""

    def __init__(self, in_feats: int, n_hidden: int, out_feats: int,
                 n_layers: int, dim: int, n_kernels: int, *,
                 dropout: float = 0.5, pseudo_in: int = 2,
                 pseudo: str = "node", gather_dtype=None,
                 dense_dtype: str = "bfloat16",
                 generator: torch.Generator | None = None):
        super().__init__()
        if pseudo not in ("node", "binned"):
            raise ValueError(f"pseudo must be 'node' or 'binned', got "
                             f"{pseudo!r}")
        self.dropout = dropout
        self.pseudo = pseudo
        convs = {}
        width = in_feats
        for i, out in enumerate([n_hidden] * n_layers + [out_feats]):
            convs[f"gmm_{i}"] = ShardedGMMConv(
                width, out, dim, n_kernels, pseudo_in=pseudo_in,
                gather_dtype=gather_dtype if pseudo == "node" else None,
                dense_dtype=dense_dtype, generator=generator)
            width = out
        self.convs = nn.ModuleDict(convs)

    def forward(self, view: ShardView, feat: torch.Tensor, pseudo, *,
                group=None, generator: torch.Generator | None = None):
        """Logits [C, out_feats] of the shard's rows; ``pseudo``: a
        NodePseudo of the shard's rows, or ``shard_edge_data``'s tables."""
        if _mode_of(pseudo) != self.pseudo:
            raise TypeError(f"this MoNet takes pseudo={self.pseudo!r} "
                            f"coordinates, got the {_mode_of(pseudo)!r} form")
        h = feat
        for i, conv in enumerate(self.convs.values()):
            if i != 0 and self.training and self.dropout > 0.0:
                h = _dropout(h, self.dropout, generator)
            h = conv(view, h, pseudo, group=group)
        return h
