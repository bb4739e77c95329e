"""The losses, optimizers and point-cloud augmentation that the training
CLIs and the sharded trainers share."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["masked_loss", "make_optimizer", "smoothed_loss", "cosine_lr",
           "SGDCosine", "make_sgd_cosine", "augment", "permutation",
           "shuffle_augment"]


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


def cosine_lr(step, decay_steps: int, init: float = 0.1,
              alpha: float = 0.01):
    """optax.cosine_decay_schedule(init, decay_steps, alpha) at ``step``:
    from init down to alpha * init, constant after ``decay_steps``.  An int
    step gives a Python float; an integer tensor step gives a float32
    tensor on its device, computed in optax's order, in float32 as optax
    computes it (``SGDCosine`` reads its step count so, on the device)."""
    if isinstance(step, torch.Tensor):
        t = step.clamp(max=decay_steps).to(torch.float32)
        c = 0.5 * (1.0 + torch.cos(math.pi * t / decay_steps))
        return init * ((1.0 - alpha) * c + alpha)
    frac = min(step, decay_steps) / decay_steps
    return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac))
                   + alpha)


class SGDCosine(torch.optim.Optimizer):
    """SGD with momentum, coupled weight decay and a per-step cosine, as
    optax.chain(add_decayed_weights(wd), sgd(cosine_decay_schedule(lr,
    decay_steps, alpha), momentum)) computes it: for every parameter with
    a gradient (batch norm's included),

        trace <- (g + wd p) + momentum trace;  p <- p - lr(step) trace

    with lr(step) = ``cosine_lr`` of the step count, clamped after
    ``decay_steps``.  The count is an int64 tensor on the parameters'
    device and the learning rate a float32 tensor computed from it there,
    so a step reads nothing on the host; the momentum buffers and the count
    are made here, before any step.  A step captured into a CUDA graph
    (utils/timing.py) therefore updates state that outlives the graph and
    takes the cosine's next value on every replay, where a learning rate
    held as a Python float would be frozen into the graph.  The same
    optimizer runs on the CPU."""

    def __init__(self, params, decay_steps: int, *, lr: float = 0.1,
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 alpha: float = 0.01):
        if decay_steps <= 0:
            raise ValueError(f"decay_steps must be positive, got "
                             f"{decay_steps}")
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay,
                                      alpha=alpha, decay_steps=decay_steps))
        params = [p for grp in self.param_groups for p in grp["params"]]
        for p in params:
            self.state[p] = dict(momentum_buffer=torch.zeros_like(
                p, memory_format=torch.preserve_format))
        self.count = torch.zeros((), dtype=torch.int64,
                                 device=params[0].device)

    def lr(self) -> torch.Tensor:
        """The learning rate the next step takes (a float32 tensor on the
        parameters' device)."""
        grp = self.param_groups[0]
        return cosine_lr(self.count, grp["decay_steps"], grp["lr"],
                         grp["alpha"])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGDCosine.step takes no closure")
        for grp in self.param_groups:
            params = [p for p in grp["params"] if p.grad is not None]
            if not params:
                continue
            bufs = [self.state[p]["momentum_buffer"] for p in params]
            d = torch._foreach_add([p.grad for p in params], params,
                                   alpha=grp["weight_decay"])
            torch._foreach_mul_(bufs, grp["momentum"])
            torch._foreach_add_(bufs, d)
            lr = cosine_lr(self.count, grp["decay_steps"], grp["lr"],
                           grp["alpha"])
            torch._foreach_sub_(params, torch._foreach_mul(bufs, lr))
        self.count.add_(1)


def make_sgd_cosine(model, decay_steps: int, *, lr: float = 0.1,
                    momentum: float = 0.9, weight_decay: float = 1e-4,
                    alpha: float = 0.01) -> SGDCosine:
    """The EdgeConv trainer's optimizer (``SGDCosine``) over every
    parameter of ``model``: lr 0.1 with a per-step cosine to 0.001 over
    ``decay_steps``, momentum 0.9, weight decay 1e-4."""
    return SGDCosine(model.parameters(), decay_steps, lr=lr,
                     momentum=momentum, weight_decay=weight_decay,
                     alpha=alpha)


def augment(x, generator):
    """Random anisotropic scale in [2/3, 3/2] and shift in [-0.2, 0.2] per
    cloud and axis (the reference's ModelNetDataset.translate)."""
    shape = (x.shape[0], 1, 3)
    s = torch.rand(shape, generator=generator, device=x.device)
    t = torch.rand(shape, generator=generator, device=x.device)
    return x * (2 / 3 + s * (3 / 2 - 2 / 3)) + (t * 0.4 - 0.2)


def permutation(n, generator):
    """A permutation of range(n) drawn on the generator's device: the
    argsort of n uniform draws, which a CUDA graph captures."""
    return torch.argsort(torch.rand(n, generator=generator,
                                    device=generator.device))


def shuffle_augment(x, y, generator):
    """An epoch's clouds and labels: a permutation of the clouds x [S, P, 3]
    and labels y [S], then each cloud's scale and shift, drawn from
    ``generator`` in that order (the DGCNN trainer's epoch)."""
    order = permutation(x.shape[0], generator)
    return augment(x[order], generator), y[order]
