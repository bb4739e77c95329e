"""How often the hub block's forward (K5) had to walk a row again, %: over
K5's launches in the last step replayed under the profiler, the block
edges walked a second time over the block's edges.  K5 walks each row at
the TPU kernel's score bound and raises its reference to the row's exact
maximum, walking the row again, where that maximum lies too far under the
bound; it counts both a row while the port's recorder probes it (the row
probe's third and fourth entries, read by ``row_raises``).  Nothing where
the port records none."""

KERNELS = ("dense_gat_fwd_kernel",)


def read(ctx):
    try:
        from dgnn_tpu_torch.utils.profiling import row_raises
    except ImportError:
        return None
    counts = [r for name, r in row_raises() if name.startswith(KERNELS)]
    edges = sum(int(r[:, 1].sum()) for r in counts)
    if edges <= 0:
        return None
    return 100.0 * sum(int(r[:, 0].sum()) for r in counts) / edges
