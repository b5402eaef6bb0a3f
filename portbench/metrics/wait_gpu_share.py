"""The "Wait GPU" scope's share of the App's frames, in %: how long the
host loop waited for its oldest frame in flight, over the untimed loops'
host frame time (the profiler's "CPU Frame" intervals). Read from the
window's loops, never from the traced one."""


def read(run):
    frame = sum(loop.frame_s for loop in run.loops)
    if frame <= 0:
        return None
    return 100.0 * sum(loop.wait_s for loop in run.loops) / frame
