#!/usr/bin/env python
"""DGCNN / EdgeConv training CLI for the PyTorch port (counterpart of
scripts/train_edgeconv.py).

Same flags and defaults as scripts/train_edgeconv.py, plus ``--device``
(default ``cuda``), ``--seed`` and ``--schedule`` (the masked-max kernel's
schedule, "step1" or "step8").  Same model (DGCNN with its default widths,
dropout 0.5), loss (label-smoothed cross entropy, eps 0.2) and optimizer
(SGD momentum 0.9, weight decay 1e-4 on every parameter, lr 0.1 with a
per-step cosine to 0.001 over ``--num-epochs`` epochs).  The clouds are
ModelNet40 when ``--dataset-path`` (or ``$DGNN_TPU_DATA``) holds
``modelnet40-sampled-2048.h5`` and h5py is importable, else synthetic point
clouds.

The whole dataset lives on the device.  Every epoch draws a permutation
and a random anisotropic scale and shift per cloud from a device
``torch.Generator``; the dynamic k-NN masks are rebuilt from the features
on the device before every EdgeConv layer.  Training runs exactly
``--num-epochs`` epochs; the steps after the first few (warmup) are timed
with CUDA events on a CUDA device.  Inference runs the test batches once
as warmup and ``--num-epochs`` times timed.  Prints train seconds per step
and per epoch, inference seconds per pass over the test batches, peak
device memory and test accuracy, and appends one CSV row named
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

import torch

from dgnn_tpu_torch.data import load_modelnet
from dgnn_tpu_torch.models import DGCNN
from dgnn_tpu_torch.utils import (CheckpointManager, append_csv_row,
                                  device_peak_memory_mb, make_sgd_cosine,
                                  reset_peak_memory, smoothed_loss,
                                  time_calls)

WARMUP_STEPS = 3


def augment(x, generator):
    """Random anisotropic scale in [2/3, 3/2] and shift in [-0.2, 0.2] per
    cloud and axis (the reference's ModelNetDataset.translate)."""
    shape = (x.shape[0], 1, 3)
    s = torch.rand(shape, generator=generator, device=x.device)
    t = torch.rand(shape, generator=generator, device=x.device)
    return x * (2 / 3 + s * (3 / 2 - 2 / 3)) + (t * 0.4 - 0.2)


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


def train_step(model, opt, sched, x, y, generator):
    """One optimizer step; returns the (detached) loss before the step."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = smoothed_loss(model(x, generator=generator), y)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


def run(args) -> dict:
    """Train and evaluate as the CLI does; returns what it printed plus the
    trained model and the clouds on the device."""
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
    total_steps = args.num_epochs * steps_per_epoch
    if total_steps <= WARMUP_STEPS:
        raise ValueError(f"{total_steps} training steps; need more than the "
                         f"{WARMUP_STEPS} warmup steps")
    xtr_d = torch.from_numpy(xtr[: steps_per_epoch * bs]).to(device)
    ytr_d = torch.from_numpy(ytr[: steps_per_epoch * bs]).long().to(device)
    n_eval = max(len(xte) // bs, 1)
    xte_d = torch.from_numpy(xte[: n_eval * bs]).to(device)
    yte_d = torch.from_numpy(yte[: n_eval * bs]).long().to(device)

    model = DGCNN(k=args.k, output_classes=n_classes, dropout=0.5,
                  schedule=args.schedule,
                  generator=torch.Generator().manual_seed(args.seed)
                  ).to(device)
    ckpt = checkpoint_manager(args)
    restored_step = None
    if args.load_model_path and ckpt is not None:
        restored_step = restore_checkpoint(ckpt, model)
        if restored_step is not None:
            print(f"restored checkpoint at step {restored_step}")
    opt, sched = make_sgd_cosine(model, total_steps)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def batches():
        for _ in range(args.num_epochs):
            order = torch.randperm(xtr_d.shape[0], generator=gen,
                                   device=device)
            xs = augment(xtr_d[order], gen)
            ys = ytr_d[order]
            for i in range(steps_per_epoch):
                yield xs[i * bs:(i + 1) * bs], ys[i * bs:(i + 1) * bs]

    feed = batches()
    losses = []

    def step():
        x, y = next(feed)
        losses.append(train_step(model, opt, sched, x, y, gen))

    print(args)
    print("profile training")
    reset_peak_memory(device)
    step_s = time_calls(step, device, iters=total_steps - WARMUP_STEPS,
                        warmup=WARMUP_STEPS)
    max_mb = device_peak_memory_mb(device)
    losses = [float(v) for v in losses]
    train_s = step_s * steps_per_epoch
    print(f"final train loss {losses[-1]:.4f}")

    print("profile inference")
    model.eval()
    correct = torch.zeros((), device=device, dtype=torch.long)

    def infer_pass():
        correct.zero_()
        for i in range(n_eval):
            logits = model(xte_d[i * bs:(i + 1) * bs])
            correct.add_((logits.argmax(dim=1)
                          == yte_d[i * bs:(i + 1) * bs]).sum())

    infer_passes = max(args.num_epochs, 1)
    with torch.no_grad():
        infer_s = time_calls(infer_pass, device, iters=infer_passes, warmup=1)
    acc = float(correct) / (n_eval * bs)

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
    return dict(losses=losses, step_s=step_s, train_s=train_s,
                infer_s=infer_s, peak_mb=max_mb, test_acc=acc,
                train_steps=total_steps,
                eval_batches=n_eval * (1 + infer_passes),
                last_lr=opt.param_groups[0]["lr"], model=model,
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
    p.add_argument("--schedule", type=str, default="step1",
                   choices=["step1", "step8"],
                   help="schedule of the masked-max kernel")
    p.add_argument("--device", type=str, default="cuda")
    return p


if __name__ == "__main__":
    run(parser().parse_args())
