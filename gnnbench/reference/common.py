"""What the plain references share: the CSR's edges on the device in
blocks, feature dropout, Adam, and the lower precisions of the control.

Plain PyTorch in float32 with TF32 off.  Nothing here imports the port
or takes anything the port built: the references work from the
benchmark's own CSR, inputs and weights.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["Edges", "dropout", "adam_step", "rounder", "precision",
           "train_steps"]

# edges a block: a block's per-edge tensors at the widest layer (4 heads x
# 64 floats) are 2 GiB each, a few of which autograd holds at once
BLOCK_EDGES = 1 << 21


class Edges:
    """The edges of a CSR over destination rows, on ``device``: ``src`` and
    ``dst`` a CSR edge (int32), ``in_degree`` a node (self loops
    included), walked in blocks of ``block`` edges."""

    def __init__(self, row_ptr: np.ndarray, col_ind: np.ndarray, device,
                 block: int = BLOCK_EDGES):
        rp = torch.from_numpy(np.asarray(row_ptr, np.int64)).to(device)
        self.num_nodes = rp.numel() - 1
        self.num_edges = int(col_ind.shape[0])
        self.in_degree = torch.diff(rp)
        self.src = torch.from_numpy(np.asarray(col_ind, np.int32)).to(device)
        self.dst = torch.repeat_interleave(
            torch.arange(self.num_nodes, dtype=torch.int32, device=device),
            self.in_degree, output_size=self.num_edges)
        self.block = block

    def blocks(self):
        """(dst, src) int64 index tensors of each block of edges."""
        for lo in range(0, self.num_edges, self.block):
            hi = min(lo + self.block, self.num_edges)
            yield self.dst[lo:hi].long(), self.src[lo:hi].long()


def dropout(x, p: float, generator):
    """Inverted feature dropout: keep an element where a uniform draw from
    ``generator`` is below 1 - p, scaled by 1 / (1 - p)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


def adam_step(params: dict, grads: dict, state: dict, t: int, lr: float,
              weight_decay: float, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> dict:
    """One Adam step with coupled weight decay (optax's
    ``chain(add_decayed_weights(wd), adam(lr))``), in place on ``params``;
    returns the gradients as the moments took them (grad + wd * param)."""
    taken = {}
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k] + weight_decay * p
            taken[k] = g
            m, v = state.setdefault(k, (torch.zeros_like(p),
                                        torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            p.sub_(lr * mhat / (vhat.sqrt() + eps))
    return taken


def _tf32(x):
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _fp8(x):
    return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32)


def rounder(kind: str | None):
    """The rounding of the per-edge operands (gathered rows, edge weights)
    in a precision: None or "float32" (the identity), "tf32" (10 mantissa
    bits), "bfloat16" or "fp8" (e4m3).  Its gradient passes straight
    through, as a cast's does."""
    if kind in (None, "float32"):
        return lambda x: x
    q = {"tf32": _tf32, "bfloat16": _bf16, "fp8": _fp8}[kind]
    return lambda x: x + (q(x.detach()) - x).detach()


@contextlib.contextmanager
def precision(kind: str | None):
    """Matrix products in float32 (TF32 off) for ``kind`` None, in TF32
    for a lower precision."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = kind is not None
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def train_steps(forward, weights: dict, labels, steps: int, drop_seed: int,
                lr: float, weight_decay: float, lowp: str | None = None,
                rows: str | None = None, fault: str | None = None) -> dict:
    """``steps`` full-graph training steps of ``forward(params, generator,
    q)`` (logits) from ``weights``: cross entropy over every node, Adam
    with coupled weight decay, feature dropout drawn from a generator
    seeded ``drop_seed`` on the labels' device.  ``rows``: the stored type
    of the per-edge operands that the configuration states (``rounder``);
    ``lowp``: the control's precision, which takes its place; ``fault``:
    "half" takes the loss over the first half of the nodes.  Returns the
    losses, the first step's gradients as Adam took them and the
    parameters after the last step."""
    import torch.nn.functional as F

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    gen = torch.Generator(device=labels.device).manual_seed(drop_seed)
    q = rounder(lowp or rows)
    state, losses, first = {}, [], None
    with precision(lowp):
        for t in range(1, steps + 1):
            logits = forward(params, gen, q)
            keep = labels.shape[0] // 2 if fault == "half" else None
            loss = F.cross_entropy(logits[:keep], labels[:keep])
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            del logits
            taken = adam_step(params, grads, state, t, lr, weight_decay)
            first = taken if first is None else first
            losses.append(float(loss.detach()))
    return dict(losses=losses, first_grads=first,
                params={k: v.detach() for k, v in params.items()})
