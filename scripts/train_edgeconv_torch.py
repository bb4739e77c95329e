#!/usr/bin/env python
"""DGCNN / EdgeConv training CLI for the PyTorch port (counterpart of
scripts/train_edgeconv.py).

Same flags and defaults as scripts/train_edgeconv.py, plus ``--device``
(default ``cuda``) and ``--seed``.  Same model (DGCNN with its default
widths, dropout 0.5), loss (label-smoothed cross entropy, eps 0.2) and
optimizer (SGD momentum 0.9, weight decay 1e-4 on every parameter, lr 0.1
with a per-step cosine to 0.001 over ``--num-epochs`` epochs, its step
count and learning rate on the device: utils/training.py ``SGDCosine``).
The clouds are ModelNet40 when ``--dataset-path`` (or the loaders'
``data_dir()``: ``$DGNN_TPU_DATA``, else ``~/.dgnn_tpu/data``) holds
``modelnet40-sampled-2048.h5`` and h5py is importable, else synthetic
point clouds.

It trains and times as the JAX CLI does (``scripts/train_edgeconv.py``:
``epoch_step`` and its protocol, :100-167), with the JAX package's
device-resident loop ported as a replayed CUDA graph
(dgnn_tpu_torch/utils/timing.py).  The whole dataset lives on the device,
and one epoch (``make_epoch``) is the unit of the loop: it draws a
permutation of the training clouds and a random anisotropic scale and
shift per cloud from a device generator, then takes every training step of
the epoch (the dynamic k-NN masks rebuilt from the features on the device
before every EdgeConv layer), writing each step's loss to a device buffer
and the epoch's mean loss and accuracy to device tensors.  Training is
timed by ``time_epoch_loop`` (1 epoch, 1 warmup epoch, doubled until 2 s,
the JAX arguments) on a throwaway copy of the model and optimizer state
with freshly seeded generators; the model then trains exactly
``--num-epochs`` epochs from its initial state by ``run_epochs`` (one
capture of the epoch, ``--num-epochs`` replays), over which peak device
memory is taken; inference is timed by ``time_epoch_loop`` over a no-grad
pass across the test batches that keeps its count of correct predictions
on the device.  On a CUDA device every epoch and inference pass is a
replayed CUDA graph (a failed capture raises); ``--device cpu`` runs the
same functions in host loops.  Prints train seconds per epoch (and per
step), inference seconds per pass over the test batches, peak device
memory and test accuracy, and appends one CSV row named
``train_edgeconv_dgnn_tpu_torch`` (train seconds per epoch).

``--load-model-path DIR`` restores the newest checkpoint in DIR (the
model's parameters and its BatchNorm statistics, as the JAX CLI restores
``params`` and ``batch_stats``) before training, and ``--save-model-path
DIR`` saves them after training under the step ``--num-epochs``
(utils/checkpoint.py), as scripts/train_edgeconv.py does.  With both
flags, both read and write the save path, as the JAX CLI does; a
directory with no checkpoint restores nothing.

    python scripts/train_edgeconv_torch.py --num-epochs 2
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import copy

import torch

from dgnn_tpu_torch.data import load_modelnet
from dgnn_tpu_torch.models import DGCNN
from dgnn_tpu_torch.utils import (CheckpointManager, append_csv_row,
                                  device_peak_memory_mb, make_sgd_cosine,
                                  reset_peak_memory, run_epochs,
                                  smoothed_loss, time_epoch_loop)
from dgnn_tpu_torch.utils.training import shuffle_augment

# The JAX CLI's timing arguments (scripts/train_edgeconv.py:136, :165):
# one epoch a run, one eager warmup epoch, runs doubled until 2 s.
TIME_EPOCHS = 1
WARMUP_EPOCHS = 1
MIN_SIGNAL_S = 2.0


def checkpoint_manager(args):
    """The CLI's CheckpointManager (the save path, else the load path), or
    None without either flag."""
    path = args.save_model_path or args.load_model_path
    return CheckpointManager(os.path.abspath(path)) if path else None


def restore_checkpoint(ckpt, model):
    """Load the newest checkpoint's parameters and BatchNorm statistics
    into ``model``; returns its step, or None if there is none."""
    restored = ckpt.restore_latest(model.state_dict())
    if restored is None:
        return None
    step, state = restored
    model.load_state_dict(state)
    return step


def train_step(model, opt, x, y, generator):
    """One optimizer step; returns the (detached) loss before the step and
    the batch's accuracy, both device tensors."""
    model.train()
    opt.zero_grad(set_to_none=True)
    logits = model(x, generator=generator)
    loss = smoothed_loss(logits, y)
    loss.backward()
    opt.step()
    acc = (logits.detach().argmax(dim=1) == y).to(torch.float32).mean()
    return loss.detach(), acc


def make_epoch(model, opt, x_train, y_train, batch_size, generator, count,
               epoch_stats, losses=None):
    """One training epoch as ``time_epoch_loop`` and ``run_epochs`` take it
    (the counterpart of the JAX CLI's ``epoch_step``): a permutation of the
    training clouds and their scale and shift drawn from ``generator`` (a
    generator on their device, which also draws the dropout), then
    ``len(x_train) // batch_size`` training steps in order.  Each step adds
    one to ``count`` (a [1] int64 device tensor) and writes its loss to
    ``losses[count]`` (a device buffer, where given); the epoch's mean loss
    and accuracy go to ``epoch_stats`` (a [2] float32 device tensor), as
    the JAX carry holds them.  Nothing is read on the host."""
    steps = x_train.shape[0] // batch_size

    def epoch():
        xs, ys = shuffle_augment(x_train, y_train, generator)
        total = torch.zeros(2, device=x_train.device)
        for i in range(steps):
            sl = slice(i * batch_size, (i + 1) * batch_size)
            loss, acc = train_step(model, opt, xs[sl], ys[sl], generator)
            if losses is not None:
                losses.index_copy_(0, count, loss.reshape(1))
            count.add_(1)
            total += torch.stack([loss, acc])
        epoch_stats.copy_(total / steps)

    return epoch


def run(args) -> dict:
    """Train and evaluate as the CLI does; returns what it printed plus the
    trained model and the clouds on the device.  ``train_steps`` and
    ``eval_batches`` are the training steps and test batches the device
    ran, counted there: the timing loops' warmups and replays, the
    ``--num-epochs`` training epochs."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    # the k-NN masks compare distances from a float32 matrix product
    torch.backends.cuda.matmul.allow_tf32 = False

    xtr, ytr, xte, yte = load_modelnet(num_points=args.num_points,
                                       path=args.dataset_path or None,
                                       train_samples=args.train_samples,
                                       test_samples=args.test_samples,
                                       seed=args.seed)
    n_classes = int(max(ytr.max(), yte.max())) + 1
    bs = args.batch_size
    steps_per_epoch = len(xtr) // bs
    if steps_per_epoch < 1 or args.num_epochs < 1:
        raise ValueError(f"{len(xtr)} training clouds in batches of {bs} "
                         f"for {args.num_epochs} epochs: no training step")
    total_steps = args.num_epochs * steps_per_epoch
    xtr_d = torch.from_numpy(xtr[: steps_per_epoch * bs]).to(device)
    ytr_d = torch.from_numpy(ytr[: steps_per_epoch * bs]).long().to(device)
    n_eval = max(len(xte) // bs, 1)
    xte_d = torch.from_numpy(xte[: n_eval * bs]).to(device)
    yte_d = torch.from_numpy(yte[: n_eval * bs]).long().to(device)

    model = DGCNN(k=args.k, output_classes=n_classes, dropout=0.5,
                  generator=torch.Generator().manual_seed(args.seed)
                  ).to(device)
    ckpt = checkpoint_manager(args)
    restored_step = None
    if args.load_model_path and ckpt is not None:
        restored_step = restore_checkpoint(ckpt, model)
        if restored_step is not None:
            print(f"restored checkpoint at step {restored_step}")
    opt = make_sgd_cosine(model, total_steps)

    def counter():
        return torch.zeros(1, dtype=torch.int64, device=device)

    def epoch_on(model_, opt_, count, losses=None):
        gen = torch.Generator(device=device).manual_seed(args.seed)
        stats = torch.zeros(2, device=device)
        return (make_epoch(model_, opt_, xtr_d, ytr_d, bs, gen, count, stats,
                           losses), gen, stats)

    print(args)
    print("profile training")
    # timing on a throwaway copy of the model and optimizer state with
    # freshly seeded generators; the accuracy from EXACTLY num_epochs
    # epochs below (the timing loop trains many more: utils.run_epochs)
    model_t = copy.deepcopy(model)
    timed = counter()
    epoch_t, gen_t, _ = epoch_on(model_t, make_sgd_cosine(model_t,
                                                          total_steps), timed)
    train_s = time_epoch_loop(epoch_t, TIME_EPOCHS, device=device,
                              warmup=WARMUP_EPOCHS, min_signal=MIN_SIGNAL_S,
                              generators=(gen_t,))
    del model_t, epoch_t
    done = counter()
    losses = torch.zeros(total_steps, device=device)
    epoch, gen, stats = epoch_on(model, opt, done, losses)
    reset_peak_memory(device)
    run_epochs(epoch, args.num_epochs, device=device, generators=(gen,))
    max_mb = device_peak_memory_mb(device)
    losses = losses.tolist()
    epoch_loss, epoch_acc = stats.tolist()
    step_s = train_s / steps_per_epoch
    print(f"final train loss {epoch_loss:.4f} acc {epoch_acc:.4f}")

    print("profile inference")
    model.eval()
    correct = torch.zeros((), device=device, dtype=torch.int64)
    passes = counter()

    def infer_pass():
        correct.zero_()
        with torch.no_grad():
            for i in range(n_eval):
                sl = slice(i * bs, (i + 1) * bs)
                logits = model(xte_d[sl])
                correct.add_((logits.argmax(dim=1) == yte_d[sl]).sum())
        passes.add_(1)

    infer_s = time_epoch_loop(infer_pass, max(args.num_epochs, 1),
                              device=device, warmup=WARMUP_EPOCHS,
                              min_signal=MIN_SIGNAL_S)
    acc = int(correct) / (n_eval * bs)

    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    print(f"Test Accuracy {acc:.4f}")
    print(f"max memory:{max_mb:.0f}MB")
    print("train time:", train_s, f"({step_s} s/step)")
    print("inference time:", infer_s)
    if args.save_model_path and ckpt is not None:
        ckpt.save(args.num_epochs, model.state_dict(), force=True)
        ckpt.wait()
        print(f"saved checkpoint to {args.save_model_path}")
    if args.output is not None:
        append_csv_row(args.output, "train_edgeconv_dgnn_tpu_torch",
                       f"{args.batch_size} {args.k}", train_s, infer_s,
                       max_mb, acc)
    infer_passes = int(passes)
    return dict(losses=losses, step_s=step_s, train_s=train_s,
                infer_s=infer_s, peak_mb=max_mb, test_acc=acc,
                epoch_loss=epoch_loss, epoch_acc=epoch_acc,
                steps_per_epoch=steps_per_epoch,
                train_steps=int(timed) + int(done),
                infer_passes=infer_passes,
                eval_batches=n_eval * infer_passes,
                last_lr=float(opt.lr()), model=model,
                restored_step=restored_step, n_classes=n_classes,
                x_train=xtr_d, y_train=ytr_d, x_test=xte_d, y_test=yte_d)


def parser():
    p = argparse.ArgumentParser(description="DGCNN (dgnn_tpu_torch)")
    p.add_argument("--dataset-path", type=str, default="")
    p.add_argument("--num-epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--k", type=int, default=40)
    p.add_argument("--num-points", type=int, default=1024)
    p.add_argument("--train-samples", type=int, default=512)
    p.add_argument("--test-samples", type=int, default=128)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--save-model-path", type=str, default="")
    p.add_argument("--load-model-path", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


if __name__ == "__main__":
    run(parser().parse_args())
