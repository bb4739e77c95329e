"""The step's model operations (projections, attention or Gaussian
weights and sums, forward and backward, counted once from the graph's size
and the widths) over the float32 peak times the step's time (train_ms of
the same run's window), %.  Nothing without a row in the table of
peaks."""


def read(ctx):
    ms = ctx.e2e.get("train_ms")
    if ctx.peaks is None or not ms:
        return None
    return 100.0 * ctx.model_flops / (ms / 1e3 * ctx.peaks["float32_flops"])
