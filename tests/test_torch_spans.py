"""The frame path's spans (``vrenderer_tpu_torch.profiler.span``) on the
CPU: what an App flythrough records in horizon and map mode (names,
parents, frames, the ``Sync`` count of each frame, and the counters
``Slots``, ``Instances`` and ``Work items``), that nothing records
without a recording profiler and that spans leave the frames unchanged,
that counters cost no operation with spans off, the shared clock with
``torch.profiler``'s events, the device trace with the spans written into
it, and the benchmark's span readers (``portbench/spans.py``,
``portbench/metrics``) on synthetic loops."""

import dataclasses
import importlib
import json
import time
from collections import Counter

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one PyTorch thread a test process)
from portbench import spans as pspans
from portbench.run import Run
from portbench.trace import Trace
from torch.utils._python_dispatch import TorchDispatchMode
from vrenderer_tpu_torch import config, profiler
from vrenderer_tpu_torch.app import App
from vrenderer_tpu_torch.camera import Camera
from vrenderer_tpu_torch.models.scene import Scene
from vrenderer_tpu_torch.profiler import FrameProfiler, span

CFG = config.FrameConfig(width=128, height=64, terrain=config.TerrainSettings(
    surface_size=512, world_size=512, max_instances=64, grid_size=8))
MODES = {"horizon": CFG,
         "map": dataclasses.replace(CFG, shadow_mode="map",
                                    shadow_resolution=128)}
FRAMES = 3

# (span, parent) of a steady frame; the cube's horizon prepass is cached
# after the first frame, and map mode shares the light view's geometry.
# One ``Setup`` a raster (``raster_cuda.setup_packed``); on the CPU its
# plain chain still copies ``pack_vis``' empty bbox to the device.
# A selection syncs on the CPU only, in the plain version's three
# compactions (on the card the kernel vrt_select syncs none).
COMMON = {("Render", None): 1, ("View", "Render"): 1,
          ("Sync", "View"): 9, ("Scene", "Render"): 1, ("Sync", "Scene"): 1,
          ("Vertex", "Render"): 2, ("Setup", "Render"): 1,
          ("Sync", "Setup"): 1, ("Bin", "Render"): 1, ("Sync", "Bin"): 1,
          ("Raster", "Render"): 1, ("Shade", "Render"): 2,
          ("Sync", "Shade"): 5, ("Select", "Render"): 1,
          ("Sync", "Select"): 3, ("Wait GPU", None): 1,
          ("CPU Frame", None): 1}
STEADY = {
    "horizon": {**COMMON, ("Terrain Shadow", None): 1,
                ("Sync", "Terrain Shadow"): 3},
    "map": {**COMMON, ("Light pass", "Render"): 1,
            ("Sync", "Light pass"): 8, ("Select", "Light pass"): 1,
            ("Vertex", "Light pass"): 1, ("Setup", "Light pass"): 1,
            ("Bin", "Light pass"): 1, ("Raster", "Light pass"): 1,
            ("Sync", "Select"): 6,
            ("Sync", "Setup"): 2, ("Sync", "Bin"): 2}}
SYNCS = {"horizon": 23, "map": 33}


def app(mode, **kw):
    return App(MODES[mode], heightmap_resolution=64, device="cpu",
               scene=Scene.default(), **kw)


def ring(prof):
    return [e for f in prof.frames for e in f["events"]]


@pytest.fixture(scope="module", params=sorted(MODES))
def flown(request):
    """(mode, App, outputs) after a flythrough with the spans on."""
    a = app(request.param)
    a.profiler.spans = True
    a.profiler.history = FRAMES + 1
    with pytest.warns(UserWarning):
        outs = a.run_flythrough(num_frames=FRAMES)
    return request.param, a, outs


def test_span_names_parents_and_frames(flown):
    mode, a, _ = flown
    evs = ring(a.profiler)
    by_id = {e["id"]: e for e in evs}
    frames = sorted({e["frame"] for e in evs if e["name"] == "Render"})
    assert len(frames) == FRAMES
    for f in frames[1:]:
        got = Counter((e["name"], by_id[e["parent"]]["name"]
                       if e["parent"] is not None else None)
                      for e in evs if e["frame"] == f)
        assert got == Counter(STEADY[mode])
    assert ("Light pass" in {e["name"] for e in evs}) == (mode == "map")
    for e in evs:           # every child lies inside its parent
        if e["parent"] is not None:
            p = by_id[e["parent"]]
            assert p["start"] <= e["start"] <= e["end"] <= p["end"]
    # "Wait GPU" carries the frame it retires, recorded a frame later
    for f in a.profiler.frames:
        waits = [e["frame"] for e in f["events"] if e["name"] == "Wait GPU"]
        if f["frame"] in frames[1:]:
            assert waits == [f["frame"] - 1]
    assert sorted(e["frame"] for e in evs
                  if e["name"] == "Wait GPU") == frames


def test_sync_count_per_frame(flown):
    mode, a, _ = flown
    evs = ring(a.profiler)
    per = Counter(e["frame"] for e in pspans.syncs(evs))
    frames = sorted({e["frame"] for e in evs if e["name"] == "Render"})
    # horizon's first frame also fills the prepass cache: one more sync
    assert [per[f] for f in frames] == (
        [SYNCS[mode] + (mode == "horizon")] + [SYNCS[mode]] * (FRAMES - 1))


def test_counters_of_each_frame(flown):
    """Every ``Select`` span carries the slots it hands to the vertex
    stage; each frame's ``Instances`` and ``Work items`` are its
    ``num_selected`` and ``num_work_items``, on the frame they count."""
    mode, a, outs = flown
    evs = ring(a.profiler)
    frames = sorted({e["frame"] for e in evs if e["name"] == "Render"})
    counters = [c for f in a.profiler.frames for c in f["counters"]]
    selects = {e["id"]: e for e in evs if e["name"] == "Select"}
    slots = [c for c in counters if c["name"] == "Slots"]
    assert sorted(c["span"] for c in slots) == sorted(selects)
    for c in slots:
        assert c["value"] == a.renderer.max_active
        assert c["frame"] == selects[c["span"]]["frame"]
    for name, field in (("Instances", "num_selected"),
                        ("Work items", "num_work_items")):
        got = {c["frame"]: c["value"] for c in counters
               if c["name"] == name}
        assert got == {f: int(getattr(o, field))
                       for f, o in zip(frames, outs)}
    assert {c["name"] for c in counters} == {"Slots", "Instances",
                                             "Work items"}


def test_spans_off_record_nothing_and_change_no_frame(flown):
    mode, a, outs = flown
    # an App with spans off (the default) records its own scopes only
    b = app(mode)
    b.profiler.history = FRAMES + 1
    with pytest.warns(UserWarning):
        plain = b.run_flythrough(num_frames=FRAMES)
    names = {e["name"] for e in ring(b.profiler)}
    assert names == {"Render", "Wait GPU", "CPU Frame"} | (
        {"Terrain Shadow"} if mode == "horizon" else set())
    assert all(f["counters"] == [] for f in b.profiler.frames)
    for o, p in zip(outs, plain):
        assert torch.equal(o.ldr, p.ldr) and torch.equal(o.prim_id, p.prim_id)
        assert torch.equal(o.depth, p.depth)
    assert b.adapt_history == a.adapt_history


class _Ops(TorchDispatchMode):
    """Counts the operators dispatched under it."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _loop_ops(mode, spans):
    a = app(mode)
    a.profiler.spans = spans
    with _Ops() as ops, pytest.warns(UserWarning):
        outs = a.run_flythrough(num_frames=FRAMES)
    return ops.ops, outs[-1]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_counters_cost_no_operation_with_spans_off(mode):
    """The loop with spans on issues, a frame, the operators of stacking
    the three counts for the flag's copy and nothing else more; with spans
    off it issues only the overflow flag's read, which the counts' list
    replaces."""
    on, out = _loop_ops(mode, True)
    off, _ = _loop_ops(mode, False)
    with _Ops() as stack:
        torch.stack([out.overflow, out.num_selected, out.num_work_items])
    with _Ops() as read:
        bool(out.overflow)
    assert on - off == Counter({k: FRAMES * v for k, v in stack.ops.items()})
    assert off - on == Counter({k: FRAMES * v for k, v in read.ops.items()})


def test_renderer_alone_records_nothing():
    a = app("horizon")
    last = profiler.last_recorder()
    before = ring(last) if last is not None else []
    assert span("Select") is span("Sync")          # the shared no-op
    # outside a recording loop, under a torch.profiler trace too
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        a.renderer.render(Camera.default())
    assert profiler.last_recorder() is last
    assert (ring(last) if last is not None else []) == before
    assert ring(a.profiler) == []
    profiler.counter("Slots", 8)                    # records nowhere
    prof = FrameProfiler(spans=True)
    with prof.recording():
        prof.begin_frame()
        with span("Select"):
            profiler.counter("Slots", 8)
        prof.end_frame()
    assert [e["name"] for e in ring(prof)] == ["Select", "CPU Frame"]
    assert prof.frames[0]["counters"] == [{
        "name": "Slots", "value": 8, "span": ring(prof)[0]["id"],
        "frame": 1}]
    assert span("Select") is span("Sync")           # off again after it
    assert profiler.active() is None


def test_spans_share_the_trace_clock():
    """A ``record_function`` issued inside a span lies inside the span's
    interval on the trace's clock; spans record on their own while the
    trace runs."""
    prof = FrameProfiler()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        with prof.recording():
            prof.begin_frame()
            with span("Select"):
                time.sleep(0.005)
                with torch.profiler.record_function("marker"):
                    time.sleep(0.002)
                time.sleep(0.005)
            prof.end_frame()
    sel = [e for e in ring(prof) if e["name"] == "Select"]
    assert len(sel) == 1
    start, end = pspans.trace_ns(dict(sel[0], clock_offset_ns=prof.frames[0][
        "clock_offset_ns"]))
    mark = [e for e in tp.profiler.kineto_results.events()
            if e.name() == "marker"]
    assert len(mark) == 1
    m0 = mark[0].start_ns()
    m1 = m0 + mark[0].duration_ns()
    assert start < m0 < m1 < end
    assert m0 - start > 2_000_000 and end - m1 > 2_000_000


def test_device_trace_holds_the_spans(tmp_path):
    a = app("map")
    a.profiler.history = FRAMES + 1
    profiler.start_device_trace(str(tmp_path))
    with pytest.warns(UserWarning):
        a.run_flythrough(num_frames=FRAMES)
    profiler.stop_device_trace()
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    host = [e for e in events if e.get("pid") == -1 and e.get("ph") == "X"]
    renders = [e for e in host if e["name"] == "Render"]
    assert len(renders) == FRAMES
    assert {"Light pass", "Select", "Sync", "Raster"} <= {
        e["name"] for e in host}
    ops = [e for e in events if e.get("ph") == "X" and e.get("pid") != -1
           and str(e.get("name", "")).startswith("aten::")]
    for r in renders:                 # the frame's operators lie inside it
        inside = [o for o in ops if r["ts"] <= o["ts"]
                  and o["ts"] + o["dur"] <= r["ts"] + r["dur"]]
        assert len(inside) > 100


# -- the benchmark's readers on a synthetic loop ------------------------------

MS = 1e-3
# one frame: (name, parent index, start ms, end ms); parents come first
FRAME = [("Render", None, 0.0, 10.0),
         ("Select", 0, 1.0, 3.0), ("Sync", 1, 2.0, 2.5),
         ("Vertex", 0, 3.0, 4.0),
         ("Light pass", 0, 4.0, 6.0), ("Select", 4, 4.0, 4.5),
         ("Sync", 5, 4.1, 4.2), ("Setup", 4, 4.5, 5.0),
         ("Setup", 0, 6.0, 7.0), ("Bin", 0, 7.0, 7.5), ("Sync", 9, 7.1, 7.4),
         ("Shade", 0, 8.0, 9.5), ("Sync", 11, 9.0, 9.1),
         ("Wait GPU", None, 10.5, 11.0), ("Sync", 13, 10.6, 10.7)]
# (name, span index or None, value a frame of 1, 2, 3): the main view's
# Select (under Render) and the light view's hand the vertex stage 8 and
# 12 slots; a frame's instances may pass its slots
COUNTERS = [("Slots", 1, (8, 8, 8)), ("Slots", 5, (12, 12, 12)),
            ("Instances", None, (3, 5, 12)), ("Work items", None, (9, 9, 9))]
WANT = {"select_host_ms": 2.5, "vertex_host_ms": 1.0, "setup_host_ms": 1.5,
        "bin_host_ms": 0.5, "light_pass_host_ms": 2.0, "shade_host_ms": 1.5,
        "host_syncs_per_frame": 4.0, "sync_wait_ms": 0.5 + 0.1 + 0.3 + 0.1,
        # frames 2 and 3: (min(5, 8) + min(12, 8)) / (8 + 8)
        "slot_fill_share": 100.0 * 13 / 16}
OFFSET = 1_700_000_000_000_000_000


def synthetic_recorder(frames=2, spec=FRAME, period_ms=20.0,
                       counters=COUNTERS):
    """A profiler made the last recorder, its ring holding ``frames``
    frames of ``spec`` and ``counters`` one ``period_ms`` after another
    (``counters=None``: a ring without counters, as before them)."""
    prof = FrameProfiler(spans=True)
    with prof.recording():
        pass
    ring_frames, k = [], 0
    for f in range(1, frames + 1):
        base = (f - 1) * period_ms
        evs = []
        for name, parent, a, b in spec:
            k += 1
            evs.append({"name": name, "start": (base + a) * MS,
                        "end": (base + b) * MS, "id": k,
                        "parent": None if parent is None
                        else k - len(evs) + parent,
                        "depth": 0, "frame": f})
        ring_frames.append({"events": evs, "start": base * MS, "frame": f,
                            "clock_offset_ns": OFFSET})
        if counters is not None:
            ring_frames[-1]["counters"] = [
                {"name": name, "value": values[f - 1], "frame": f,
                 "span": None if at is None else evs[at]["id"]}
                for name, at, values in counters]
    prof.frames = ring_frames
    return prof


def synthetic_run(frames=2, starts=(), ends=()):
    trace = Trace(window_s=1.0, frames=frames, names=["k"] * len(starts),
                  start_ns=np.array(starts, dtype=np.int64),
                  end_ns=np.array(ends, dtype=np.int64))
    return Run(cell=None, loops=[], trace=trace)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_span_metric_readers(metric):
    read = importlib.import_module(f"portbench.metrics.{metric}").read
    synthetic_recorder(frames=3)
    assert read(synthetic_run(frames=2)) == pytest.approx(WANT[metric])
    assert read(synthetic_run(frames=4)) is None   # the ring is too short
    assert read(Run(cell=None, loops=[], trace=None)) is None


def test_slot_fill_share_needs_the_counters():
    """A ring without counters (a program before them) or without the
    main view's ``Slots`` reads None."""
    from portbench.metrics import slot_fill_share

    synthetic_recorder(frames=3, counters=None)
    assert slot_fill_share.read(synthetic_run(frames=2)) is None
    synthetic_recorder(frames=3, counters=COUNTERS[1:])
    assert slot_fill_share.read(synthetic_run(frames=2)) is None


def test_idle_by_span_splits_gaps_by_the_innermost_span():
    synthetic_recorder(frames=1)
    events = pspans.loop_spans(1)

    def ns(ms):
        return OFFSET + round(ms * 1e6)

    # device busy [0, 1.5], [2.2, 4.6], [8, 12], [13, 14] ms: the gap
    # [1.5, 2.2] falls in Select (0.5) and its Sync (0.2); [4.6, 8] in
    # the light pass's Setup (0.4), the light pass (1.0), Setup (1.0), Bin
    # (0.2) and its Sync (0.3), and Render (0.5); [12, 13] in no span
    starts = [ns(0.0), ns(2.2), ns(8.0), ns(13.0)]
    ends = [ns(1.5), ns(4.6), ns(12.0), ns(14.0)]
    run = synthetic_run(1, starts, ends)
    launches = [ns(0.5), ns(2.3), ns(4.15), ns(7.2), ns(12.5)]
    got = {k: (v, n) for k, v, n in pspans.idle_by_span(
        run.trace, events, launches, top=100)}
    want = {"Select": (0.5, 0), "Sync": (0.5, 3), "Setup": (1.4, 0),
            "Light pass": (1.0, 0), "Bin": (0.2, 0), "Render": (0.5, 1),
            pspans.OUTSIDE: (1.0, 1)}
    assert set(got) == set(want)
    for k, (v, n) in want.items():
        assert got[k][0] == pytest.approx(v * MS) and got[k][1] == n
    top = pspans.idle_by_span(run.trace, events, top=2)
    assert len(top) == 2 and top[0][0] == "Setup"
    # self times: Render's is what its children leave
    selfs = pspans.self_ms(events, 1)
    assert selfs["Render"] == pytest.approx(10.0 - 2.0 - 1.0 - 2.0 - 1.0
                                            - 0.5 - 1.5)
    assert selfs["Light pass"] == pytest.approx(2.0 - 0.5 - 0.5)
