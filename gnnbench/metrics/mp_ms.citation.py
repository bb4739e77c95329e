"""Device milliseconds a step of the port's own kernels (the degree bins'
kernels here: no hub block).  Nothing where no own kernel ran."""

from gnnbench.trace import OWN


def read(ctx):
    own = ctx.trace.seconds(OWN) / ctx.trace.steps
    return 1e3 * own if own > 0 else None
