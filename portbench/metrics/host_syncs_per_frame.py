"""Host syncs a frame: the program's ``Sync`` spans outside "Wait GPU",
each a call on the frame's issue path that blocks the host until the
card's queue has drained (a read to the host, a copy from pageable host
memory, a pivot check), over the traced loop's frames."""

from portbench import spans


def read(run):
    events = spans.run_spans(run)
    if events is None:
        return None
    return len(spans.syncs(events)) / run.trace.frames
