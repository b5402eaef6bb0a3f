"""Device activities a frame: the kernels, copies and sets of one whole
traced loop, over its frames."""


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    return len(run.trace.names) / run.trace.frames
