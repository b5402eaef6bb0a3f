"""One loop under ``torch.profiler``, reduced to what the per-layer
metrics read: the device's activities (kernels, copies, sets) with their
names and times, their union (the busy time), and the idle gaps between
them.

The benchmark traces one whole loop itself, around the App's call, with
the profiler recording the device's activities alone, which slows the
host's issue least (about 1.5-fold). The profiler's events are read
straight from its results (``kineto_results.events()``), without building
its per-event Python objects or writing a trace file, so a loop of some
200,000 device activities reduces in seconds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch


@dataclass
class Trace:
    window_s: float                 # the traced loop's host wall time
    frames: int                     # frames the loop rendered
    names: List[str]                # device activities, in start order
    start_ns: np.ndarray
    end_ns: np.ndarray

    @property
    def busy_s(self) -> float:
        """The union of the device's activity intervals, in seconds."""
        if not len(self.start_ns):
            return 0.0
        busy, cur_s, cur_e = 0, self.start_ns[0], self.end_ns[0]
        for s, e in zip(self.start_ns[1:], self.end_ns[1:]):
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            elif e > cur_e:
                cur_e = e
        return float(busy + cur_e - cur_s) * 1e-9

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in zip(self.names, self.start_ns, self.end_ns):
            out[n] = out.get(n, 0.0) + float(e - s) * 1e-9
        return out

    def idle_by_next(self) -> Dict[str, float]:
        """The device's idle seconds between its first and last activity,
        by the activity that ended each gap: the work the host was issuing
        while the device waited."""
        out: Dict[str, float] = {}
        cur_e = None
        for n, s, e in zip(self.names, self.start_ns, self.end_ns):
            if cur_e is not None and s > cur_e:
                out[n] = out.get(n, 0.0) + float(s - cur_e) * 1e-9
            cur_e = e if cur_e is None else max(cur_e, e)
        return out


def _device_events(events):
    dev = []
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            dur = e.duration_ns()
            if dur > 0:
                dev.append((e.start_ns(), e.start_ns() + dur, e.name()))
    return dev


def trace_loop(run_loop: Callable[[], int]) -> Trace:
    """Run ``run_loop`` (which returns the frames it rendered) under the
    profiler, recording the device's activities, the device idle before
    and after, and reduce it."""
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    frames = run_loop()
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    prof.stop()
    dev = sorted(_device_events(prof.profiler.kineto_results.events()))
    return Trace(window_s=window_s, frames=frames,
                 names=[d[2] for d in dev],
                 start_ns=np.array([d[0] for d in dev], dtype=np.int64),
                 end_ns=np.array([d[1] for d in dev], dtype=np.int64))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The line's ``breakdown``: the device operations that took most
    time in the traced loop, and its idle time by the operation the device
    waited for ("until <name>"); seconds each."""
    def ranked(d, prefix=""):
        return [[prefix + k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(trace.seconds_by_name()),
            "idle_gaps": ranked(trace.idle_by_next(), "until ")}
