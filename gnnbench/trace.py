"""The device trace of a short steady stretch: kernels by group, busy and
idle time, and the breakdown the result line carries.

Groups of device operations, by name (the rule holds when a later change
renames a kernel or adds one):

- ``gemm``: a library matrix product (cuBLAS, cuBLASLt, CUTLASS): a name
  with ``gemm``, ``gemv``, ``xmma``, ``cublas``, ``cutlass`` or
  ``splitKreduce``;
- ``copy``: a memcpy or memset;
- ``torch``: PyTorch's own kernels, a name with ``at::`` or ``native``, or
  one of the few PyTorch kernels that lie in an anonymous namespace
  (``softmax_warp_`` of its persistent softmax, ``cunn_``) or in CUB
  (``cub::``);
- ``own``: every other kernel, the port's hand-written ones.

The glue is every operation that is neither ``gemm`` nor ``own``.
"""

from __future__ import annotations

__all__ = ["group", "Trace", "profile", "union", "OWN", "GLUE"]

_LIBRARY = ("gemm", "gemv", "xmma", "cublas", "cutlass", "splitkreduce")
_TORCH = ("at::", "native", "softmax_warp_", "cunn_", "cub::")
OWN = ("own",)
GLUE = ("torch", "copy")


def group(name: str) -> str:
    """The group of a device operation's name."""
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "copy"
    if any(k in low for k in _LIBRARY):
        return "gemm"
    if any(k in name for k in _TORCH):
        return "torch"
    return "own"


def union(intervals):
    """The disjoint, sorted union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device operations ``ops`` and host events ``host``, each a list of
    (name, start_us, end_us), over ``steps`` steps or requests."""

    def __init__(self, ops, host, steps: int):
        if not ops:
            raise RuntimeError("the trace holds no device operation")
        self.ops, self.host, self.steps = ops, host, steps
        self.busy = union((s, e) for _, s, e in ops)
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6
        self.window_s = (self.busy[-1][1] - self.busy[0][0]) / 1e6

    def seconds(self, groups) -> float:
        """Device seconds of the operations in ``groups``."""
        return sum(e - s for n, s, e in self.ops if group(n) in groups) / 1e6

    def launches(self) -> int:
        """Kernels launched (memcpy and memset not counted)."""
        return sum(1 for n, _, _ in self.ops if group(n) != "copy")

    def names(self, groups) -> list:
        return sorted({n for n, _, _ in self.ops if group(n) in groups})

    def breakdown(self, top: int = 10) -> dict:
        """The ``top`` device operations by time, and the ``top`` longest
        idle gaps named by the innermost host event open at the gap's
        start."""
        by = {}
        for n, s, e in self.ops:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(((a[1], b[0]) for a, b in zip(self.busy,
                                                    self.busy[1:])),
                      key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in gaps:
            open_ = [h for h in self.host if h[1] <= s < h[2]]
            label = (max(open_, key=lambda h: h[1])[0] if open_
                     else "no host event")
            named.append([label, (e - s) / 1e6])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def profile(run, steps: int) -> Trace:
    """``run()`` (``steps`` steps, ending in a synchronize) under
    torch.profiler with CPU and CUDA activities."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    ops, host = [], []
    for ev in prof.events():
        rec = (ev.name, ev.time_range.start, ev.time_range.end)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ops.append(rec)
        else:
            host.append(rec)
    return Trace(ops, host, steps)
