"""k4_roofline: the path walk's (K4, two launches a pass) least time over
its device time, in percent, summed over the window. The least time is
the bytes of each device pass's (B, N) inputs and outputs at the card's
HBM bandwidth (portbench.counts)."""

from portbench import counts

KERNELS = ("walk_tree_kernel", "walk_util_kernel")


def read(run):
    seconds, launches = run.device_trace.kernel_time(*KERNELS)
    n_bytes = sum(counts.walk_bytes(b, run.n_tiles) for s in run.searches
                  for c in s.calls for b in c.chunks)
    least = counts.least_seconds(n_bytes, run.device_name)
    if not launches or not n_bytes or least is None:
        return None
    return 100.0 * least / seconds
