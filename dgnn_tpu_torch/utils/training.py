"""The loss and optimizer that the training CLIs share."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["masked_loss", "make_optimizer"]


def masked_loss(logits, labels, train_mask):
    """Mean softmax cross-entropy over the rows where ``train_mask``."""
    losses = F.cross_entropy(logits, labels, reduction="none")
    mask = train_mask.to(losses.dtype)
    return (losses * mask).sum() / mask.sum()


def make_optimizer(model, lr: float, weight_decay: float):
    # Adam's weight_decay adds wd * param to the gradient before the moment
    # updates: optax.chain(add_decayed_weights(wd), adam(lr))
    return torch.optim.Adam(model.parameters(), lr=lr,
                            weight_decay=weight_decay)
