"""The numbers that decide ``correct``, each held to its limit.

Training (the program's first steps against the reference's):

- ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  over the steps; ``loss1_gap`` the same of the first step alone;
- ``grad_gap``: by the worst leaf, the gap between the norm of the first
  gradient as the optimizer took it and the reference's, over the larger
  of the reference's norm of that leaf and of the median leaf;
- ``delta_gap``: the same for the parameters' change over the steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move under Adam by rounding alone);
  ``delta_median_gap`` the median of those leaves' gaps.

A cell compares the numbers its limits file names (``limits/<cell>.json``).

Inference (each sampled request's logits against the reference's):

- ``logit_gap``: the largest |logit - reference| over the reference's
  largest |logit|;
- ``logit_rms_gap``: ||logits - reference|| / ||reference||.
"""

from __future__ import annotations

import math

import torch

__all__ = ["leaf_gaps", "leaf_gap", "training_numbers", "inference_numbers",
           "judge"]

# the share of the median leaf's gradient norm under which a leaf's change
# is rounding alone
_STILL = 1e-3


def _worst(values) -> float:
    """The largest of ``values``; infinity where one is not a number."""
    values = list(values)
    return math.inf if any(math.isnan(v) for v in values) else max(values)


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list:
    """Over leaves (those in ``keep``, or all): |‖prog‖ - ‖ref‖| /
    max(‖ref‖ of the leaf, median ‖ref‖ over the leaves)."""
    pn, rn = _norms(prog), _norms(ref)
    keys = [k for k in rn if keep is None or k in keep]
    med = sorted(rn[k] for k in keys)[len(keys) // 2]
    return [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys]


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return _worst(leaf_gaps(prog, ref, keep))


def training_numbers(losses, ref_losses, grads, ref_grads, delta,
                     ref_delta) -> dict:
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    gn = _norms(ref_grads)
    med = sorted(gn.values())[len(gn) // 2]
    moving = {k for k, v in gn.items() if v >= _STILL * med}
    deltas = sorted(leaf_gaps(delta, ref_delta, moving))
    return dict(loss_gap=_worst(gaps), loss1_gap=_worst(gaps[:1]),
                grad_gap=leaf_gap(grads, ref_grads),
                delta_gap=_worst(deltas),
                delta_median_gap=_worst([deltas[len(deltas) // 2]]))


def inference_numbers(outputs, ref) -> dict:
    ref = ref.double()
    top = float(ref.abs().max())
    rn = float(torch.linalg.vector_norm(ref))
    gaps, rms = [], []
    for out in outputs:
        d = out.double() - ref
        gaps.append(float(d.abs().max()) / top)
        rms.append(float(torch.linalg.vector_norm(d)) / rn)
    return dict(logit_gap=_worst(gaps), logit_rms_gap=_worst(rms))


def judge(numbers: dict, limits: dict) -> bool:
    """Every number the limits name finite and at or under its limit; a
    limit without its number fails."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= v for k, v in limits.items())
