"""search_s: host seconds from the start of the window's first search to
the end of its last, over the number of searches. Every search is whole
and ends in a device sync."""


def read(run):
    return run.window_s / len(run.searches)
