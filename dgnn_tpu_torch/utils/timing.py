"""Timing and device memory for the port.

On a CUDA device a run of calls is bracketed by CUDA events after a warmup
(the device clock, not the host's enqueue time).  On the CPU, where the
user asked for the CPU, the host clock is the device clock.  There is no
counterpart of the JAX package's device-resident fori_loop protocol
(dgnn_tpu/utils/timing.py:39): PyTorch dispatches each step from the host.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["time_calls", "peak_memory_mb", "reset_peak_memory"]


def time_calls(fn: Callable[[], object], device: torch.device, *,
               iters: int, warmup: int = 3) -> float:
    """Seconds per call of ``fn()`` on ``device``, after ``warmup`` calls."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    if device.type != "cpu":
        raise ValueError(f"no timer for device {device}")
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def reset_peak_memory(device: torch.device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_memory_mb(device: torch.device) -> float:
    """Peak allocated device memory (MB) since the last reset; -1 where the
    device has no allocator statistics (the CPU)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device) / (1024 * 1024)
    return -1.0
