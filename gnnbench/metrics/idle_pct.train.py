"""The device's idle share of the traced stretch, %: the time no device
operation ran, over the span from the first operation's start to the
last one's end."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
