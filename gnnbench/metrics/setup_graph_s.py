"""Seconds of set-up in the port's graph: the root ``dgnn.graph.*`` spans of
the port's recorder in this process (the cache's load, or the build and
its save; the copy to the device).  Nothing where the port records none."""


def read(ctx):
    try:
        from dgnn_tpu_torch.utils.profiling import totals
    except ImportError:
        return None
    secs = [s for name, (_, s) in totals(roots=True).items()
            if name.startswith("dgnn.graph.")]
    return sum(secs) if secs else None
