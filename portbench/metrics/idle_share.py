"""idle_share: the percent of the traced window (first search's start to
last search's end) in which no operation ran on the device: one minus the
union of the device's kernel, copy and set intervals over the window."""


def read(run):
    t = run.device_trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
