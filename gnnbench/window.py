"""The measured window: training steps replayed back to back, or requests
sent by one client in a closed loop, and the end-to-end arithmetic.

The functions take their clock and their device waits as arguments, so
that the tests can drive them with synthetic records.
"""

from __future__ import annotations

import math
import time
from collections import deque

__all__ = ["train_window", "infer_window", "train_ms", "percentile",
           "cuda_marker", "request", "LEAD"]

# steps the host enqueues ahead of the device in a training window: far
# enough that the device never waits for the host, in every cell alike
LEAD = 32


def cuda_marker():
    """A CUDA event recorded now on the current stream; ``wait()`` blocks
    the host until the device has passed it."""
    import torch

    ev = torch.cuda.Event()
    ev.record()
    return ev.synchronize


def train_window(replay, seconds: float, *, lead: int = LEAD,
                 marker=cuda_marker, clock=time.perf_counter):
    """Replay steps back to back for ``seconds`` of the host's clock and
    drain them.  The host waits only for the step ``lead`` steps back, so
    the device always has queued work and never waits for a host sync.
    Returns (steps, seconds from the first enqueue to the end of the
    drain)."""
    pending = deque()
    steps = 0
    t0 = clock()
    while clock() - t0 < seconds:
        replay()
        pending.append(marker())
        steps += 1
        if len(pending) > lead:
            pending.popleft()()
    while pending:
        pending.popleft()()
    return steps, clock() - t0


def train_ms(steps: int, wall_s: float) -> float:
    """Milliseconds a training step over the whole window: its wall time,
    drain included, over the steps completed in it."""
    if steps <= 0:
        raise ValueError("the window completed no step")
    return 1e3 * wall_s / steps


def request(replay, wait, clock=time.perf_counter) -> float:
    """Send one request (``replay()``) and wait for its result
    (``wait()``): its milliseconds on the host's clock, from the send to
    the result, the launch and the wake-up included."""
    t0 = clock()
    replay()
    wait()
    return 1e3 * (clock() - t0)


def infer_window(request, seconds: float, *, after=None,
                 clock=time.perf_counter):
    """One client in a closed loop for ``seconds`` of the host's clock:
    ``request()`` sends a request, waits for its result and returns its
    milliseconds; ``after(i)``, where given, runs after request ``i``
    outside its time.  Returns every request's milliseconds."""
    lat = []
    t0 = clock()
    while clock() - t0 < seconds:
        lat.append(request())
        if after is not None:
            after(len(lat) - 1)
    return lat


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of ``values`` (0 < q <= 100):
    the smallest value with at least q % of the values at or below it."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    return v[max(math.ceil(q / 100.0 * len(v)), 1) - 1]
