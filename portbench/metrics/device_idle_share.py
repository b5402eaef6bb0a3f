"""The device's idle share of a frame loop, in %: one less the traced
loop's device busy time (the union of its activities' intervals) over the
mean wall time of the window's untraced loops. The profiler slows the
host's issue, not the device's work, so the traced loop's own wall time
would count the profiler's cost as idle."""


def read(run):
    t = run.trace
    if t is None or not t.names or not run.loops or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / (run.window_s / len(run.loops)))
