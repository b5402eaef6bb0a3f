"""The program's frame-path spans in a traced loop, reduced to what the
span metrics and the span report read.

The program (``vrenderer_tpu_torch.profiler``) records a span at each
layer boundary of a frame (``Select``, ``Vertex``, ``Setup``, ``Bin``,
``Raster``, ``Light pass``, ``Shade``, ``View``, ``Scene``) and one
``Sync`` around every call that blocks the host until the card's queue
drains, nested inside the App's "Render", "Terrain Shadow" and "Wait GPU"
scopes. Its loops record them while a ``torch.profiler`` trace runs, so
the benchmark's traced loop carries them; the profiler that recorded last
keeps its ring (``last_recorder``). Each span has its name, its start and
end on the ring's clock, its parent and the frame it belongs to, and each
frame of the ring the offset from the ring's clock to the trace's.

Where the program records no spans (a commit before them) every reader
here returns None.

    python3 portbench/spans.py --workload <cell> --seed <n> [--pairs 6]

reports a cell's spans on the card (``report``): each layer's host and
self time, the syncs, the device's idle time by the span open on the host
(``idle_by_span``), the spans' cost, a check of the ``Sync`` spans against
``torch.cuda.set_sync_debug_mode("warn")`` (``sync_check``) and the
export time of
``profiler.start_device_trace`` over one loop. ``--dry-run`` rehearses it
on the CPU at a tiny frame.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
import warnings
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

OUTSIDE = "outside spans"
# host runtime calls that put an activity on the card's queue
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def loop_spans(frames: int) -> Optional[List[dict]]:
    """The spans of the last ``frames`` frames that issued a "Render" in the
    ring of the program's last span recorder, each with its ring frame's
    ``clock_offset_ns``; None where the program records none or the ring
    holds fewer frames."""
    try:
        from vrenderer_tpu_torch import profiler
    except ImportError:
        return None
    last = getattr(profiler, "last_recorder", None)
    prof = last() if last is not None else None
    if prof is None or frames <= 0:
        return None
    events = [dict(ev, clock_offset_ns=f["clock_offset_ns"])
              for f in prof.frames for ev in f["events"]]
    rendered = sorted({e["frame"] for e in events
                       if e["name"] == "Render"})[-frames:]
    if len(rendered) < frames:
        return None
    keep = set(rendered)
    return [e for e in events if e["frame"] in keep]


def run_spans(run) -> Optional[List[dict]]:
    """``loop_spans`` of a ``run.Run``'s traced loop."""
    if run.trace is None or not run.trace.frames:
        return None
    return loop_spans(run.trace.frames)


def per_frame_ms(events: List[dict], name: str, frames: int
                 ) -> Optional[float]:
    """The summed duration of the spans called ``name``, in ms a frame;
    None where there is none."""
    durs = [e["end"] - e["start"] for e in events if e["name"] == name]
    if not durs:
        return None
    return 1e3 * sum(durs) / frames


def host_ms(run, name: str) -> Optional[float]:
    """A layer's inclusive host time a frame of the traced loop, ms."""
    events = run_spans(run)
    if events is None:
        return None
    return per_frame_ms(events, name, run.trace.frames)


def syncs(events: List[dict]) -> List[dict]:
    """The ``Sync`` spans outside "Wait GPU" (the frame's issue path)."""
    by_id = {e["id"]: e for e in events}

    def waiting(e):
        while e is not None:
            if e["name"] == "Wait GPU":
                return True
            e = by_id.get(e["parent"])
        return False

    return [e for e in events if e["name"] == "Sync" and not waiting(e)]


def self_ms(events: List[dict], frames: int) -> Dict[str, float]:
    """Each span name's self time a frame, ms: its spans' durations less
    the part their child spans cover."""
    child = defaultdict(float)
    for e in events:
        if e["parent"] is not None:
            child[e["parent"]] += e["end"] - e["start"]
    out: Dict[str, float] = defaultdict(float)
    for e in events:
        out[e["name"]] += e["end"] - e["start"] - child[e["id"]]
    return {k: 1e3 * v / frames for k, v in out.items()}


def trace_ns(e: dict):
    """A span's (start, end) on the trace's clock, ns."""
    off = e["clock_offset_ns"]
    return round(e["start"] * 1e9) + off, round(e["end"] * 1e9) + off


def innermost(events: List[dict]):
    """[(start, end, name)] on the trace's clock: the innermost span open
    over each stretch of the host's time (the App's "CPU Frame" interval
    is no span of work and is left out)."""
    spans = sorted(((*trace_ns(e), e["name"]) for e in events
                    if e["name"] != "CPU Frame"),
                   key=lambda x: (x[0], -x[1]))
    out, stack, t = [], [], None
    for s, e, name in spans:
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            if t < end:
                out.append((t, end, top))
            t = max(t, end)
        if stack:
            if t < s:
                out.append((t, s, stack[-1][1]))
            e = min(e, stack[-1][0])        # rounding: inside its parent
        t = s
        stack.append((e, name))
    while stack:
        end, top = stack.pop()
        if t < end:
            out.append((t, end, top))
            t = end
    return out


def idle_gaps(start_ns, end_ns):
    """The device's idle gaps [(start, end)] between its first and last
    activity (intervals sorted by start)."""
    gaps, cur_e = [], None
    for s, e in zip(start_ns, end_ns):
        if cur_e is not None and s > cur_e:
            gaps.append((int(cur_e), int(s)))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def idle_by_span(trace, events: List[dict], launch_ns=None,
                 top: int = 10) -> list:
    """The traced loop's device idle seconds by the innermost span open on
    the host during each gap, a gap split across spans split by overlap,
    time outside every span as ``OUTSIDE``; the ``top`` largest, as
    ``trace.breakdown``'s ``idle_gaps`` are given. With ``launch_ns`` (the
    host's launch calls on the trace's clock) each entry also counts the
    launches issued inside its span."""
    segs = innermost(events)
    idle: Dict[str, float] = defaultdict(float)
    j = 0
    for a, b in idle_gaps(trace.start_ns, trace.end_ns):
        covered = 0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                idle[segs[k][2]] += (hi - lo) * 1e-9
                covered += hi - lo
            k += 1
        if b - a > covered:
            idle[OUTSIDE] += (b - a - covered) * 1e-9
    launches: Dict[str, int] = defaultdict(int)
    if launch_ns is not None:
        j = 0
        for t in sorted(launch_ns):
            while j < len(segs) and segs[j][1] <= t:
                j += 1
            inside = j < len(segs) and segs[j][0] <= t
            launches[segs[j][2] if inside else OUTSIDE] += 1
    ranked = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    if launch_ns is None:
        return [[k, v] for k, v in ranked]
    return [[k, v, launches.get(k, 0)] for k, v in ranked]


# -- the span report (a cell on the card) ------------------------------------

def _trace_loop(run_loop, on_card: bool):
    """One loop under ``torch.profiler`` (device activities on the card,
    as ``trace.trace_loop`` records them): (``trace.Trace``, the host's
    launch calls' start times)."""
    import numpy as np
    import torch

    from portbench import trace as tracemod

    acts = [torch.profiler.ProfilerActivity.CUDA if on_card
            else torch.profiler.ProfilerActivity.CPU]
    if on_card:
        torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    t0 = time.perf_counter()
    frames = run_loop()
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    prof.stop()
    evs = prof.profiler.kineto_results.events()
    dev = sorted(tracemod._device_events(evs))
    launch_ns = [e.start_ns() for e in evs
                 if e.name().startswith(LAUNCHES)
                 and not str(e.device_type()).endswith("CUDA")]
    t = tracemod.Trace(window_s=window_s, frames=frames,
                       names=[d[2] for d in dev],
                       start_ns=np.array([d[0] for d in dev], dtype=np.int64),
                       end_ns=np.array([d[1] for d in dev], dtype=np.int64))
    return t, launch_ns


def span_cost_us(n: int = 200_000) -> dict:
    """Host microseconds a ``with span(...)`` block costs, with no profiler
    recording (off) and under a recording one (on)."""
    from vrenderer_tpu_torch.profiler import FrameProfiler, span

    def timed():
        t0 = time.perf_counter()
        for _ in range(n):
            with span("Sync"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    t_loop = time.perf_counter()
    for _ in range(n):
        pass
    base = (time.perf_counter() - t_loop) / n * 1e6
    off = timed()
    prof = FrameProfiler(spans=True, history=1)
    with prof.recording():
        prof.begin_frame()
        on = timed()
        prof.end_frame()
    return {"off_us": off - base, "on_us": on - base, "spans": n}


def sync_check(app, fly, frames: int) -> dict:
    """One App loop of ``frames`` frames with the spans on under
    ``torch.cuda.set_sync_debug_mode("warn")``. Each warning, a call that
    synchronised, records a "Warned" span of its own where it is raised,
    so its parent names the span it fell in: a frame's ``Sync`` spans and
    its warnings inside them should be as many."""
    import torch

    from vrenderer_tpu_torch.profiler import span

    def show(*args, **kwargs):
        with span("Warned"):
            pass

    app.profiler.spans = True
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            app.run_flythrough(num_frames=frames, **fly)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            app.profiler.spans = False
    events = loop_spans(frames)
    by_id = {e["id"]: e for e in events}
    where = defaultdict(int)
    for e in events:
        if e["name"] == "Warned":
            parent = by_id.get(e["parent"])
            where[parent["name"] if parent else OUTSIDE] += 1
    return {"warnings_per_frame": {k: v / frames for k, v in where.items()},
            "sync_spans_per_frame": len(syncs(events)) / frames}


def layer_table(events: List[dict], frames: int) -> dict:
    """Each span name's inclusive and self ms a frame and count a frame."""
    selfs = self_ms(events, frames)
    names = sorted({e["name"] for e in events})
    return {n: {"ms": per_frame_ms(events, n, frames),
                "self_ms": selfs[n],
                "count": sum(e["name"] == n for e in events) / frames}
            for n in names}


def report(args) -> dict:
    import torch

    from portbench import cell as cellmod
    from portbench import run as runmod
    from vrenderer_tpu_torch import profiler

    cell = cellmod.load(args.workload)
    if args.dry_run:
        cell = cell.scaled(**runmod.DRY_RUN)
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the report measures the card")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = device.type == "cuda"
    hm, albedo = runmod.build_inputs(cell, device)
    app = runmod.build_app(cell, args.seed, hm, albedo, device)
    n = cell.frames
    fly = dict(dt=float(cell.traffic["dt"]),
               frames_in_flight=int(cell.traffic["frames_in_flight"]))

    def loop():
        app.run_flythrough(num_frames=n, **fly)
        if on_card:
            torch.cuda.synchronize()
        return n

    loop()                                   # warm: every shape
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(device) if on_card
           else "cpu",
           "power_limit": runmod._smi("power.limit") if on_card else None,
           "span_cost": span_cost_us()}

    # whole loops with the spans off and on, in turns
    pairs = {"off": [], "on": []}
    for k in range(args.pairs):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            app.profiler.spans = on
            t0 = time.perf_counter()
            loop()
            pairs["on" if on else "off"].append(
                1e3 * (time.perf_counter() - t0) / n)
    app.profiler.spans = False
    out["frame_ms_pairs"] = pairs
    if pairs["off"]:
        out["frame_ms_median"] = {k: statistics.median(v)
                                  for k, v in pairs.items()}

    # the traced loop: spans on the device's timeline
    tr, launch_ns = _trace_loop(loop, on_card)
    events = loop_spans(n)
    table = layer_table(events, n)
    sync = syncs(events)
    render = table["Render"]
    idle = idle_by_span(tr, events, launch_ns)
    every = dict(idle_by_span(tr, events, top=10 ** 6))
    idle_s = sum(every.values())
    outside = every.get(OUTSIDE, 0.0)
    out.update({
        "layers": table,
        "host_syncs_per_frame": len(sync) / n,
        "sync_wait_ms": 1e3 * sum(e["end"] - e["start"] for e in sync) / n,
        "render_self_share": render["self_ms"] / render["ms"],
        "idle_by_span": idle,
        "idle_s": idle_s, "outside_share": outside / idle_s if idle_s else 0.0,
        "launches": len(launch_ns), "traced_loop_s": tr.window_s,
        "busy_s": tr.busy_s})

    if on_card:
        out["sync_check"] = sync_check(app, fly, 8)

    # the device trace over one loop, and its export time
    with tempfile.TemporaryDirectory() as logdir:
        profiler.start_device_trace(logdir)
        loop()
        t0 = time.perf_counter()
        profiler.stop_device_trace()
        stop_s = time.perf_counter() - t0
        path = os.path.join(logdir, "trace.json")
        with open(path) as fh:
            doc = json.load(fh)
        out["device_trace"] = {
            "stop_s": stop_s, "bytes": os.path.getsize(path),
            "events": len(doc["traceEvents"]),
            "span_events": sum(e.get("pid") == -1 and e.get("ph") == "X"
                               for e in doc["traceEvents"])}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=6,
                    help="loops with the spans off and on, in turns")
    ap.add_argument("--dry-run", action="store_true",
                    help="rehearse on the CPU at a tiny size")
    out = report(ap.parse_args(argv))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
