"""The host's time in syncs a frame, in ms: the summed duration of the
``Sync`` spans that ``host_syncs_per_frame`` counts, over the traced
loop's frames."""

from portbench import spans


def read(run):
    events = spans.run_spans(run)
    if events is None:
        return None
    return 1e3 * sum(e["end"] - e["start"]
                     for e in spans.syncs(events)) / run.trace.frames
