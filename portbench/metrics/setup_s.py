"""setup_s: host seconds from the process's start to the first timed
search: imports, loading (on a checkout's first run, building) the NoC
kernels, the problem, one warm search, and in a traced run the profiler's
first session."""


def read(run):
    return run.setup_s
