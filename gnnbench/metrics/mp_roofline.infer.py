"""The message-passing kernels' share of their roofline, %: the least time
the step's message passing could take (each pass its bytes over the
memory's rate or its operations over the float32 rate, whichever is
larger; counted from the graph's size and the widths), over the device
time of the port's own kernels a step.  Nothing where no own kernel ran or
the card has no row in the table of peaks."""

from gnnbench.trace import OWN


def read(ctx):
    own = ctx.trace.seconds(OWN) / ctx.trace.steps
    if own <= 0 or ctx.least_mp_s is None:
        return None
    return 100.0 * ctx.least_mp_s / own
