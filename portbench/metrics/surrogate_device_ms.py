"""surrogate_device_ms: device milliseconds of the surrogate's kernels,
K2 (forest_predict) and K3 (score_block_max), per search. Nothing to read
where the search asks no surrogate."""

KERNELS = ("forest_predict_cluster_kernel", "score_block_max_cluster_kernel")


def read(run):
    seconds, launches = run.device_trace.kernel_time(*KERNELS)
    return 1e3 * seconds / len(run.searches) if launches else None
