"""A request's model operations (the projections, the attention
columns and the message passing of one forward, counted once from the
graph's size and the widths) over the float32 peak times the request's
time (infer_ms.p95 of the same run's window), %.  Nothing without a row
in the table of peaks."""


def read(ctx):
    ms = ctx.e2e.get("infer_ms.p95")
    if ctx.peaks is None or not ms:
        return None
    return 100.0 * ctx.model_flops / (ms / 1e3 * ctx.peaks["float32_flops"])
