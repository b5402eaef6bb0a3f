"""Run one cell of the benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. A cell of
``BENCHMARK.json`` names a configuration (``configs/<name>.json``: the
terrain, the scene, the shadow mode and its budget) and a traffic mix
(``traffic/<name>.json``: the frame size, the work budget, the camera
path and its length, and what the seed varies, ``traffic.py``).

A run builds the inputs (the heightmap and its albedo, from the
configuration), the program's ``App`` with a ``Renderer`` of the cell's
budgets, flying the traffic's camera path (``camera_path``), and warms up
with one whole loop of ``App.run_flythrough``: all of that is
``setup_s``, from the process's start. The window is whole loops, as
many as it takes to pass ``--seconds``, ended by a device
synchronisation: ``frame_ms`` is its
wall time over the frames it rendered, ``frame_p95_ms`` the 95th
percentile of the App profiler's host intervals of those frames. With
``--trace 1`` one more whole loop runs under ``torch.profiler``, recording
the device's activities, and the line carries the per-layer metrics
(``metrics/<name>.py``) and the trace's ``breakdown`` instead.

Then the program's state is freed and the plain reference
(``portbench/reference``) checks the window's output (``check.py``). The
last line of standard output is the result; its ``checks`` key, last,
gives each number compared beside its limit, as do the last lines of
standard error. Without a card, or with fewer than the cell asks for, it
prints no result and exits 2. ``--dry-run`` rehearses a run on the CPU at
a tiny frame and four cameras (the harness's own tests); its line names
the CPU.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

_T0 = time.perf_counter()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "vrenderer_tpu")
# the program's poses of each camera path but the App's own flythrough:
# the JAX bench's mode of ``vrenderer_tpu_torch.workloads.cameras``
PROGRAM_MODES = {"ground": "ground", "walk": "mapwalk", "orbit": "envelope"}
DRY_RUN = {"width": 240, "height": 144, "cameras": 4}


def process_age_s() -> float:
    """Seconds since this process started, from /proc (0 where that
    cannot be read)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = process_age_s()


def _setup_s(now: float) -> float:
    return _AGE0 + (now - _T0)


def _smi(query: str) -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


@dataclass
class Loop:
    """One whole call of ``App.run_flythrough``, from its profiler."""

    frames: int
    frame_ms: List[float]      # host intervals of its frames
    frame_s: float = 0.0       # its "CPU Frame" intervals, summed
    render_s: float = 0.0      # its "Render" scopes
    wait_s: float = 0.0        # its "Wait GPU" scopes


def loop_stats(profiler, frames: int) -> Loop:
    """The last loop's frames from the App's profiler (its ring holds one
    loop and the drain interval after it; the drain's wait counts, its
    interval is no frame)."""
    ring = profiler.frames[-(frames + 1):]
    times = list(profiler.frame_times_ms[-(frames + 1):-1])
    loop = Loop(frames=frames, frame_ms=times)
    for f in ring:
        for ev in f["events"]:
            dur = ev["end"] - ev["start"]
            if ev["name"] == "CPU Frame":
                loop.frame_s += dur
            elif ev["name"] == "Render":
                loop.render_s += dur
            elif ev["name"] == "Wait GPU":
                loop.wait_s += dur
    return loop


@dataclass
class Run:
    """What the per-layer metric readers read."""

    cell: object
    loops: List[Loop]
    window_s: float = 0.0      # the untraced window's wall time
    trace: object = None
    counts: list = field(default_factory=list)
    peaks: Optional[dict] = None


def p95(values: List[float]) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def build_inputs(cell, device):
    """The heightmap and its albedo: the benchmark's own, from the
    configuration, on ``device``; both sides get these tensors."""
    from portbench.reference import heightmap as ref_hm

    spec = cell.config["heightmap"]
    if spec["kind"] != "procedural":
        raise ValueError(f"unknown heightmap kind {spec['kind']!r}")
    hm = ref_hm.procedural_heightmap(int(spec["resolution"]),
                                     int(spec["seed"]), device=device)
    return hm, ref_hm.procedural_albedo(hm)


def build_app(cell, seed: int, hm, albedo, device):
    """The program's App with a Renderer of the cell's budgets, the
    benchmark's terrain and the seed's shading."""
    from vrenderer_tpu_torch import config as prog_config
    from vrenderer_tpu_torch.app import App
    from vrenderer_tpu_torch.models.scene import Scene
    from vrenderer_tpu_torch.renderer import Renderer

    cfg = cell.frame_config(prog_config)
    if cell.config["scene"] != "boot_cube":
        raise ValueError(f"unknown scene {cell.config['scene']!r}")
    path = camera_path(cell)
    app = App(cfg, heightmap_resolution=int(hm.shape[0]), device=device)
    app.heightmap = hm
    app.albedo = albedo
    app.renderer = Renderer(cfg, hm, albedo,
                            max_work=int(cell.traffic["max_work"]),
                            max_active=int(cell.config["max_active"]),
                            scene=Scene.default(device), device=device)
    app.params = program_params(cell, seed, device)
    app.profiler.history = cell.frames + 1
    if path != "flythrough":
        fly_poses(app, program_poses(path, cell.frames, hm,
                                     float(cfg.terrain.world_size)))
    return app


def camera_path(cell) -> str:
    """The traffic's camera path; a ValueError names the paths there are."""
    from portbench.reference import camera

    path = cell.traffic["path"]
    if path not in camera.PATHS:
        raise ValueError(f"unknown camera path {path!r}; one of "
                         f"{', '.join(camera.PATHS)}")
    return path


def program_poses(path: str, frames: int, hm, world_size: float):
    """The program's own first ``frames`` poses of the camera path: the
    App's flythrough, or the JAX bench's mode of ``workloads.cameras``."""
    if path == "flythrough":
        from vrenderer_tpu_torch.camera import flythrough

        return flythrough(frames, world_size=world_size, heightmap=hm,
                          max_height=400.0)
    from vrenderer_tpu_torch import workloads
    from vrenderer_tpu_torch.camera import Camera

    poses = workloads.cameras(PROGRAM_MODES[path], hm, world_size)
    if poses.eye.shape[0] < frames:
        raise ValueError(f"the {path} path has {poses.eye.shape[0]} poses, "
                         f"not {frames}")
    return Camera(*(f[:frames] for f in poses))


def fly_poses(app, poses):
    """Make ``app.run_flythrough(num_frames=n)`` fly the first ``n`` of
    ``poses``, a path whose poses do not depend on its length.

    ``App.run_flythrough`` flies the scripted flythrough of the App
    module's ``flythrough`` and takes no poses. For the length of each
    call that name stands for ``poses``; the App's loop is otherwise its
    own, and the name is put back when the call returns."""
    from vrenderer_tpu_torch import app as app_module
    from vrenderer_tpu_torch.camera import Camera

    loop = app.run_flythrough

    def scripted(num_frames, **_):
        if num_frames > poses.eye.shape[0]:
            raise ValueError(f"a loop of {num_frames} frames; the path has "
                             f"{poses.eye.shape[0]} poses")
        return Camera(*(f[:num_frames] for f in poses))

    def run_flythrough(**kwargs):
        own = app_module.flythrough
        app_module.flythrough = scripted
        try:
            return loop(**kwargs)
        finally:
            app_module.flythrough = own

    app.run_flythrough = run_flythrough


def program_params(cell, seed: int, device):
    """The program's FrameParams: its defaults with the seed's shading."""
    import torch
    from vrenderer_tpu_torch.renderer import FrameParams

    from portbench import traffic

    seeded = traffic.frame_params(cell.traffic, seed)
    return FrameParams.default(device=device)._replace(**{
        k: torch.tensor(v, dtype=torch.float32, device=device)
        for k, v in seeded.items()})


def build_reference(cell, hm, albedo, device):
    """The reference renderer of the cell on the same inputs, and its
    own poses of a loop of the cell's camera path."""
    from portbench.reference import camera, config, renderer, scene

    path = camera_path(cell)
    cfg = cell.frame_config(config)
    ref = renderer.Renderer(cfg, hm, albedo, int(cell.traffic["max_work"]),
                            int(cell.config["max_active"]),
                            scene.Scene.default(device), device)
    cams = camera.path(path, cell.frames, hm,
                       float(cfg.terrain.world_size), max_height=400.0)
    return ref, cams


def reference_params(cell, seed: int, device):
    """The reference's FrameParams: the default sun and the seed's
    shading."""
    import torch
    from portbench import traffic
    from portbench.reference import config, renderer

    seeded = traffic.frame_params(cell.traffic, seed)

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return renderer.FrameParams(
        max_height=t(400.0), ambient_intensity=t(seeded["ambient_intensity"]),
        light_direction=t(config.LightParams().direction),
        light_irradiance=t(seeded["light_irradiance"]),
        light_color=t(seeded["light_color"]), exposure=t(seeded["exposure"]))


def frame_counts(outs) -> List[tuple]:
    """(raw selection count, work items, overflow mask) of each frame."""
    import torch

    rows = torch.stack([torch.stack([o.num_selected.long(),
                                     o.num_work_items.long(),
                                     o.overflow_mask.long()])
                        for o in outs]).cpu().tolist()
    return [tuple(r) for r in rows]


def kept_frame(app, outs, loop: int, cam: int):
    """Camera ``cam``'s frame of the App's last loop, with the adaptation
    carry before and after it."""
    from portbench import check

    o = outs[cam]
    lums = [0.5] + list(app.adapt_history)
    return check.Kept(loop=loop, camera=cam, ldr=o.ldr, prim_id=o.prim_id,
                      depth=o.depth, lum_before=lums[cam],
                      lum_after=lums[cam + 1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dry-run", action="store_true",
                    help="rehearse on the CPU at a tiny size")
    args = ap.parse_args(argv)

    import torch

    from portbench import cell as cellmod
    from portbench import check, trace, traffic

    cell = cellmod.load(args.workload)
    if args.dry_run:
        cell = cell.scaled(**DRY_RUN)
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} here", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.type == "cuda"
    phases = {"imports_s": _setup_s(time.perf_counter())}

    def mark(name):
        phases[name] = _setup_s(time.perf_counter())

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    hm, albedo = build_inputs(cell, device)
    app = build_app(cell, args.seed, hm, albedo, device)
    n = cell.frames
    fly = dict(num_frames=n, dt=float(cell.traffic["dt"]),
               frames_in_flight=int(cell.traffic["frames_in_flight"]))
    mark("app_s")

    # set-up: one whole loop reaches every camera's shapes and the
    # allocator's peak
    warm = app.run_flythrough(**fly)
    warm_counts = frame_counts(warm)
    del warm
    heaviest = max(range(n), key=lambda i: warm_counts[i][1])
    checked = traffic.checked_cameras(cell.traffic, args.seed, heaviest)
    sync()
    gc.collect()

    loops, prog_counts = [], []
    first, last = None, {}
    t_first = time.perf_counter()
    setup_s = _setup_s(t_first)
    phases["setup_s"] = setup_s
    while True:
        outs = app.run_flythrough(**fly)
        loops.append(loop_stats(app.profiler, n))
        prog_counts.append(frame_counts(outs))
        if first is None:
            first = kept_frame(app, outs, 0, 0)
        last = {cam: kept_frame(app, outs, len(loops) - 1, cam)
                for cam in checked}
        del outs
        if time.perf_counter() - t_first >= args.seconds:
            break
    sync()
    window_s = time.perf_counter() - t_first
    frames = n * len(loops)
    # the start of the first loop, the checked cameras of the last
    kept = [first] + [last[cam] for cam in checked]

    mark("window_end_s")
    result_trace = None
    if args.trace:
        if not on_card:
            raise SystemExit("--trace 1 needs the card")

        def traced_loop():
            app.run_flythrough(**fly)
            return n

        result_trace = trace.trace_loop(traced_loop)
        mark("traced_s")
    memory_peak = (torch.cuda.max_memory_allocated(device) if on_card
                   else 0)
    prog_field = None
    if cell.config["shadow_mode"] == "horizon":
        prog_field = app.renderer.cached_horizon_prepass(app.params)[0]

    # the program's state goes before the reference runs
    del app
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ref, cams = build_reference(cell, hm, albedo, device)
    params = reference_params(cell, args.seed, device)
    ref_counts = [ref.counts(cams.frame(i), params) for i in range(n)]
    mark("reference_counts_s")
    loop_work = {
        "selected": sum(c.selected for c in ref_counts),
        "work_items": sum(c.work_items for c in ref_counts),
        "light_work_items": sum(c.light_work_items for c in ref_counts),
        "program_selected": [sum(r[0] for r in loop) for loop in prog_counts],
        "program_work_items": [sum(r[1] for r in loop)
                               for loop in prog_counts],
        "program_most_work_items": max(r[1] for loop in prog_counts
                                       for r in loop),
    }
    numbers = check.count_numbers(prog_counts, ref_counts)
    numbers.update(check.frame_numbers(kept, ref, cams, params,
                                       float(cell.traffic["dt"])))
    numbers.update(check.shadow_numbers(prog_field, ref, params))
    mark("reference_frames_s")
    checks = check.judge(numbers, cell.config.get("limits", {}))
    correct = check.passed(checks)
    failed = int(numbers["count_mismatch"] + numbers["overflow_frames"])
    if not correct:
        failed = max(failed, 1)

    print(json.dumps({"loop_work": loop_work, "loops": len(loops),
                      "checked_cameras": checked, "phases": phases,
                      "loop_ms": [1e3 * loop.frame_s / n for loop in loops]}), flush=True)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    if args.trace:
        peaks = json.loads((HERE / "peaks.json").read_text()).get(
            device_info["kind"])
        run = Run(cell=cell, loops=loops, window_s=window_s,
                  trace=result_trace, counts=ref_counts, peaks=peaks)
        metrics = {}
        for m in spec["per_layer"]:
            if "workloads" in m and cell.name not in m["workloads"]:
                continue
            value = importlib.import_module(
                f"portbench.metrics.{m['name']}").read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = result_trace.busy_s
        device_info["window_s"] = result_trace.window_s
        print(f"card {_smi('name,power.limit')}", file=sys.stderr)
    else:
        ft = [t for loop in loops for t in loop.frame_ms]
        values = {"frame_ms": 1e3 * window_s / frames,
                  "frame_p95_ms": p95(ft), "setup_s": setup_s}
        metrics = {}
        for m in spec["end_to_end"]:
            if "workloads" in m and cell.name not in m["workloads"]:
                continue
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3

    line = {"correct": correct, "attempted": frames, "failed": failed,
            "metrics": metrics, "device": device_info}
    if args.trace:
        line["breakdown"] = trace.breakdown(result_trace)
    # JSON has no infinity: a number that is not finite prints as 1e308
    line["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"])
                          else 1e308, "limit": c["limit"]}
                      for k, c in checks.items()}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
