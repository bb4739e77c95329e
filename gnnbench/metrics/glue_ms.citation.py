"""Device milliseconds a step of the glue: every device operation that is
neither a library matrix product nor one of the port's own kernels
(torch elementwise and reduction kernels, the combine gathers, cat, Adam,
memcpy and memset)."""

from gnnbench.trace import GLUE


def read(ctx):
    glue = ctx.trace.seconds(GLUE) / ctx.trace.steps
    return 1e3 * glue if glue > 0 else None
