"""The share of the window's steps replayed in the slow mode, %: from the
port's replay series (a CUDA event after a replay call at most every
50 ms of host time, with the replays so far), the intervals between
unprofiled samples, the first left out; the share of their replays in
intervals more than 3 % slower a replay than the median of the fastest
tenth of intervals.  Nothing where the port records no series."""


def read(ctx):
    try:
        from dgnn_tpu_torch.utils.profiling import replay_points, slow_share
    except ImportError:
        return None
    return slow_share(replay_points())
