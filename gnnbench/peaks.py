"""The card's published peaks, by the name ``torch.cuda.get_device_name``
gives: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit.  float32 is the rate outside the tensor cores: the port's matrix
products run in float32 with TF32 off (torch's default).  A card not in
the table has its roofline and peak shares left out."""

from __future__ import annotations

__all__ = ["PEAKS", "least_seconds"]

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12,
                                  float32_flops=67e12),
}


def least_seconds(passes, pk: dict) -> float:
    """The least time of a sequence of passes, each (flops, bytes): each
    pass at least its bytes over the memory's rate and its operations over
    the float32 rate, whichever is larger."""
    return sum(max(b / pk["hbm_bytes_per_s"], f / pk["float32_flops"])
               for f, b in passes)
