"""Kernels launched on the device a step (memcpy and memset not counted):
what the replayed CUDA graph issues."""


def read(ctx):
    return ctx.trace.launches() / ctx.trace.steps
