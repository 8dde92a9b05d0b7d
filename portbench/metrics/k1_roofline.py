"""k1_roofline: the APSP kernel's (K1) least time over its device time, in
percent, summed over the window. The least time is the bytes of each
device pass's (B, N) cost and distance matrices at the card's HBM
bandwidth (portbench.counts). Passes whose routing tables come from the
host (the evaluator's incremental moves) launch no K1 and are not
counted."""

from portbench import counts

KERNELS = ("apsp_kernel", "minplus_kernel")


def read(run):
    seconds, launches = run.device_trace.kernel_time(*KERNELS)
    n_bytes = sum(counts.apsp_bytes(b, run.n_tiles) for s in run.searches
                  for c in s.calls if c.apsp for b in c.chunks)
    least = counts.least_seconds(n_bytes, run.device_name)
    if not launches or not n_bytes or least is None:
        return None
    return 100.0 * least / seconds
