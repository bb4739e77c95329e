#!/usr/bin/env python
"""Study of the tiled masked-max kernels for EdgeConv on the card
(counterpart of scripts/exp_r5_ec_tiles.py).

    out[b, i, f] = max_j (mask[b, i, j] + hs[b, j, f])

At the JAX study's shapes (B=64, P=1024, F=256, a random float32 mask of
{0, -1e9} that admits 40 / P of the columns) it times the plain PyTorch
version (cloud by cloud, so that its broadcast fits) and the hand-written
kernel of dgnn_tpu_torch/csrc/ec_tiles.cu in both schedules ("step1": one
candidate column per inner step; "step8": eight mask values and eight hs
rows held in registers per step), with and without the first-winner index,
by CUDA events in turns.  Both schedules walk the lists of live candidates
that the kernels' list pass makes of the mask first (ops/ec_tiles.py
``live_candidates``); the script times that pass alone too
(``live_counts``) and prints the mean number of live candidates a row and
the rows that overflow a list and are walked densely, and the share of the
mask's 64 x 64 tiles that hold an admitted entry (what skipping empty column
tiles, instead of listing, would leave to walk).  Per variant it prints
ms, dense candidate-channels per second (B * P * P * F / s, what the dense
form walks), admitted candidate-channels per second (what the mask lets
through), and the largest difference from the plain version, which must be
0: the max is exact.
``--mask knn`` takes the model's mask instead: ``knn_mask_neg`` of random
points, bfloat16 with -1e30.  The last line is one JSON object with every
number.  ``--device cpu`` runs the plain version only (a CPU tensor never
reaches a kernel).

    python scripts/exp_ec_tiles_torch.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import subprocess

import torch

from dgnn_tpu_torch.graph.knn import knn_mask_neg
from dgnn_tpu_torch.ops import ec_tiles
from dgnn_tpu_torch.utils import time_calls

NEG = -1e9  # the float32 study mask, as the JAX script's
TILE = 64   # side of the column tiles whose skipping touched_tiles weighs


def make_inputs(device, b=64, p=1024, f=256, k=40, mask="f32", seed=0):
    """(mask_neg [B, P, P], hs [B, P, F]) drawn on ``device`` from a seed:
    ``mask="f32"`` admits each column with probability k / P (float32, 0 or
    NEG); ``mask="knn"`` is the model's k-NN mask of random 3-D points
    (bfloat16, 0 or -1e30)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    hs = torch.randn((b, p, f), generator=gen, device=device)
    if mask == "knn":
        pts = torch.randn((b, p, 3), generator=gen, device=device)
        return knn_mask_neg(pts, k), hs
    if mask != "f32":
        raise ValueError(f"mask must be 'f32' or 'knn', got {mask!r}")
    admit = torch.rand((b, p, p), generator=gen, device=device) < k / p
    zero = torch.zeros((), device=device)
    return torch.where(admit, zero, zero + NEG), hs


def touched_tiles(mask_neg):
    """Share of a mask's TILE x TILE tiles (rows x candidate columns) that
    hold at least one admitted (zero) entry: what a kernel that skips empty
    column tiles would still have to walk.  None unless P is a multiple of
    TILE."""
    b, p, _ = mask_neg.shape
    if p % TILE:
        return None
    t = p // TILE
    hit = (mask_neg == 0).view(b, t, TILE, t, TILE).any(dim=4).any(dim=2)
    return float(hit.float().mean())


def study(device, b=64, p=1024, f=256, k=40, mask="f32", iters=10, seed=0):
    """Rows of (variant, ms, rates, max error), plain first."""
    device = torch.device(device)
    mask_neg, hs = make_inputs(device, b, p, f, k, mask, seed)
    admitted = int((mask_neg == 0).sum())
    want, want_i = ec_tiles.masked_max_plain(mask_neg, hs, with_index=True)
    counts = ec_tiles.live_counts(mask_neg, hs)
    listed = counts >= 0
    list_pass_ms = None
    if device.type == "cuda":
        # the list pass against the rule's plain statement, then its time
        n_live = ec_tiles.live_candidates(mask_neg, hs).sum(
            dim=-1, dtype=torch.int32)
        assert torch.equal(counts, torch.where(
            n_live > ec_tiles.LIVE_CAP, -1, n_live).to(torch.int32))
        list_pass_ms = time_calls(
            lambda: ec_tiles.live_counts(mask_neg, hs), device, iters=iters,
            warmup=2) * 1e3
    variants = [("plain", False, lambda: ec_tiles.masked_max_plain(
        mask_neg, hs))]
    if device.type == "cuda":
        for schedule in ec_tiles.SCHEDULES:
            for with_index in (False, True):
                variants.append((
                    schedule + (" +index" if with_index else ""), with_index,
                    lambda s=schedule, w=with_index: ec_tiles.masked_max(
                        mask_neg, hs, schedule=s, with_index=w)))
    rows = []
    for name, with_index, fn in variants:
        got = fn()
        if with_index:
            got, got_i = got
            assert torch.equal(got_i, want_i), f"{name}: index differs"
        err = float((got - want).abs().max())
        assert err == 0.0, f"{name}: differs from the plain version by {err}"
        plain = name == "plain"
        s = time_calls(fn, device, iters=2 if plain else iters,
                       warmup=1 if plain else 2)
        rows.append(dict(variant=name, ms=s * 1e3,
                         dense_cand_per_s=b * p * p * f / s,
                         admitted_cand_per_s=admitted * f / s,
                         max_abs_err=err))
    return dict(shape=dict(B=b, P=p, F=f, k=k, mask=mask,
                           mask_dtype=str(mask_neg.dtype),
                           admitted_per_row=admitted / (b * p),
                           touched_tile_share=touched_tiles(mask_neg),
                           live_per_listed_row=float(
                               counts[listed].float().mean()) if bool(
                                   listed.any()) else None,
                           dense_rows=int((~listed).sum()),
                           live_cap=ec_tiles.LIVE_CAP),
                list_pass_ms=list_pass_ms, rows=rows)


def card(device):
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--features", type=int, default=256)
    ap.add_argument("--k", type=int, default=40)
    ap.add_argument("--mask", choices=["f32", "knn"], default="f32")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("exp_ec_tiles_torch: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    res = study(args.device, args.batch, args.points, args.features, args.k,
                args.mask, args.iters, args.seed)
    res["card"] = card(args.device)
    print(f"[ec_tiles] {res['shape']} | {res['card']}")
    if res["list_pass_ms"] is not None:
        print(f"[ec_tiles] list pass      : {res['list_pass_ms']:9.3f} ms  "
              "(hs ranges + live lists; inside every kernel variant's time)")
    for r in res["rows"]:
        print(f"[ec_tiles] {r['variant']:14s}: {r['ms']:9.3f} ms  "
              f"{r['dense_cand_per_s'] / 1e9:8.1f} G dense cand-ch/s  "
              f"{r['admitted_cand_per_s'] / 1e9:7.1f} G admitted  "
              f"max err {r['max_abs_err']:.1e}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
