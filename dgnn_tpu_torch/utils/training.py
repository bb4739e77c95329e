"""The loss and optimizer that the training CLIs share."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["masked_loss", "make_optimizer", "smoothed_loss", "cosine_lr",
           "make_sgd_cosine"]


def masked_loss(logits, labels, train_mask):
    """Mean softmax cross-entropy over the rows where ``train_mask``."""
    losses = F.cross_entropy(logits, labels, reduction="none")
    mask = train_mask.to(losses.dtype)
    return (losses * mask).sum() / mask.sum()


def make_optimizer(model, lr: float, weight_decay: float):
    """Adam with coupled L2 weight decay: its weight_decay adds wd * param to
    the gradient before the moment updates, which is what
    optax.chain(add_decayed_weights(wd), adam(lr)) computes.

    For parameters on a CUDA device it is Adam's ``capturable`` form (its
    step count lives on the device; the same update) with its state made
    here, as its first step would make it: a step captured into a CUDA
    graph (utils/timing.py) then updates that state in place, where a
    state first made inside the capture would be made again, zeroed, on
    every replay.  On the CPU it is the plain Adam."""
    params = list(model.parameters())
    cuda = any(p.is_cuda for p in params)
    opt = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay,
                           capturable=cuda)
    if cuda:
        for p in params:
            opt.state[p] = dict(
                step=torch.zeros((), dtype=torch.float32, device=p.device),
                exp_avg=torch.zeros_like(p,
                                         memory_format=torch.preserve_format),
                exp_avg_sq=torch.zeros_like(
                    p, memory_format=torch.preserve_format))
    return opt


def smoothed_loss(logits, labels, eps: float = 0.2):
    """Label-smoothed cross entropy of the EdgeConv trainer: 1 - eps on the
    label and eps / (n - 1) on each OTHER class.
    (``F.cross_entropy(label_smoothing=eps)`` spreads eps / n over all n
    classes, the label included, and is a different loss.)"""
    n_cls = logits.shape[1]
    one_hot = F.one_hot(labels.long(), n_cls).to(logits.dtype)
    smooth = one_hot * (1.0 - eps) + (1.0 - one_hot) * (eps / (n_cls - 1))
    return -(smooth * F.log_softmax(logits, dim=1)).sum(dim=1).mean()


def cosine_lr(step: int, decay_steps: int, init: float = 0.1,
              alpha: float = 0.01) -> float:
    """optax.cosine_decay_schedule(init, decay_steps, alpha) at ``step``:
    from init down to alpha * init, constant after ``decay_steps``."""
    frac = min(step, decay_steps) / decay_steps
    return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac))
                   + alpha)


def make_sgd_cosine(model, decay_steps: int, *, lr: float = 0.1,
                    momentum: float = 0.9, weight_decay: float = 1e-4,
                    alpha: float = 0.01):
    """(optimizer, scheduler) of the EdgeConv trainer: SGD with momentum and
    coupled weight decay on EVERY parameter, batch norm's included (what
    optax.chain(add_decayed_weights(wd), sgd(schedule, momentum)) computes),
    and a per-step cosine from ``lr`` to ``alpha * lr``.  Call
    ``scheduler.step()`` after each ``optimizer.step()``."""
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum,
                          weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: cosine_lr(step, decay_steps, 1.0, alpha))
    return opt, sched
