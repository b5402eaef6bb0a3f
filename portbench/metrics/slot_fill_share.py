"""The share of the main view's instance slots that carry a selected
instance, in %: 100 x the sum of min(``Instances``, ``Slots``) over the sum
of ``Slots`` of the main view's ``Select`` (the one whose parent is
"Render"), over the traced loop's frames. ``Slots`` is what that span
hands to the vertex stage, setup and binning (``min(max_active,
max_instances)``), ``Instances`` the frame's ``num_selected``; in map
cells both are the light selection's, whose slots the main view reuses.

The counters lie beside the spans in the ring of the program's last span
recorder (``spans.loop_spans`` reads the spans the same way); None where
the program records no counters or the ring holds fewer frames."""


def _ring():
    try:
        from vrenderer_tpu_torch import profiler
    except ImportError:
        return None
    last = getattr(profiler, "last_recorder", None)
    prof = last() if last is not None else None
    return None if prof is None else prof.frames


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    ring = _ring()
    if ring is None:
        return None
    events = [e for f in ring for e in f["events"]]
    counters = [c for f in ring for c in f.get("counters", ())]
    frames = sorted({e["frame"] for e in events
                     if e["name"] == "Render"})[-run.trace.frames:]
    if not counters or len(frames) < run.trace.frames:
        return None
    renders = {e["id"] for e in events if e["name"] == "Render"}
    main = {e["id"] for e in events
            if e["name"] == "Select" and e["parent"] in renders}
    slots = {c["frame"]: c["value"] for c in counters
             if c["name"] == "Slots" and c["span"] in main}
    selected = {c["frame"]: c["value"] for c in counters
                if c["name"] == "Instances"}
    if any(f not in slots or f not in selected for f in frames):
        return None
    total = sum(slots[f] for f in frames)
    return 100.0 * sum(min(selected[f], slots[f]) for f in frames) / total
