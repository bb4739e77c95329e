"""Seconds of set-up in the device-resident loop: the port's recorder's
spans of every ``StepGraph`` warm-up and capture in this process (the
kernel library's load nested inside).  Nothing where the port records
none."""

NAMES = ("dgnn.stepgraph.warmup", "dgnn.stepgraph.capture")


def read(ctx):
    try:
        from dgnn_tpu_torch.utils.profiling import totals
    except ImportError:
        return None
    secs = [s for name, (_, s) in totals().items() if name in NAMES]
    return sum(secs) if secs else None
