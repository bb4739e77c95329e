"""The hub-block forward's tail, %: over the launches of K5 in the last
request replayed under the profiler, sum(T - t95) over sum(T).  T is a
launch's last row end less its first row start, t95 the time after the
first start by which 95 % of its rows had ended: the kernel's row spans
(``%globaltimer`` at each block row's start and end), read from the port's
recorder in this process.  Nothing where the port records none."""

KERNELS = ("dense_gat_fwd_kernel",)


def read(ctx):
    try:
        from dgnn_tpu_torch.utils.profiling import row_spans, tail_pct
    except ImportError:
        return None
    return tail_pct([r for name, r in row_spans()
                     if name.startswith(KERNELS)])
