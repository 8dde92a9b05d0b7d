"""edp_ratio: the mean over the window's searches of the front's least
network EDP (f-weighted latency over all pairs, times energy) over the 3D
mesh's, both computed by the reference (paper 6.1)."""


def read(run):
    return sum(run.verdict.edp_ratio) / len(run.verdict.edp_ratio)
