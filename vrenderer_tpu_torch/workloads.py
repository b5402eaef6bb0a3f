"""The workload modes of the JAX package's bench (bench.py:33-230), as the
port's own code, and the per-camera statistics of its ``scripts/tail.py``.

* ``build(mode)``: the renderer, frame parameters and 64 cameras of one
  mode, with bench.py's configuration and budgets: ``1080p`` (the
  default), ``4k``, ``map``, ``mapref``, ``mapcache``, ``mapsnap``,
  ``mapwalk``, ``envelope`` and ``ground``; ``quant`` and ``shadow_res``
  are bench.py's ``--quant`` and ``--shadowres``.
* ``probe``: bench.py's overflow probe at camera 0, and the envelope's
  selection above the default 512-instance budget.
* ``steady_frames``: every camera once, with the cache a user's loop pays
  for (``App.run_flythrough``'s rules, bench.py's chains): the horizon
  prepass computed once, ``mapcache``'s light-eye map rastered once, and
  ``mapsnap``'s and ``mapwalk``'s quantized-eye map rastered again exactly
  when the eye crosses into another cell (``cell_crossings``).
* ``camera_stats``: per camera the frame's CUDA-event time beside the
  terms that may explain it (selected instances, work items, valid
  triangles, and the (triangle, pixel) pairs kernel B1's block test
  evaluates, ``raster_cuda.block_pair_rects``), with the spread and each
  term's correlation with the time.

Run on the card:

    python -m vrenderer_tpu_torch.workloads --mode M [--quant Q]
        [--shadowres R] [--frames N] [--tail] [--passes]

prints the probe, the steady loop's light rasters, ``--tail`` one line a
camera and the summary, ``--passes`` the ``App.profile_passes`` table of
the mode's renderer. It prints no frame rate: the workloads are inputs,
not a benchmark. The JAX package's ``scripts/prep_time.py`` times
prefixes of a jitted chain only because XLA prunes what a chain does not
consume; the port's passes run eagerly, and ``--passes`` gives their
times.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from vrenderer_tpu_torch.camera import Camera, flythrough
from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings
from vrenderer_tpu_torch.models.scene import Scene
from vrenderer_tpu_torch.ops import raster_cuda
from vrenderer_tpu_torch.renderer import (
    FrameOutput, FrameParams, Renderer, overflow_message,
)
from vrenderer_tpu_torch.terrain import heightmap as hmod

MODES = ("1080p", "4k", "map", "mapref", "mapcache", "mapsnap", "mapwalk",
         "envelope", "ground")
MAP_MODES = ("map", "mapref", "mapcache", "mapsnap", "mapwalk")
QUANT_MODES = ("mapsnap", "mapwalk")     # the quantized-eye shadow cache
N_CAMERAS = 64
MAX_HEIGHT = 400.0
# the envelope's point: camera 0 selects beyond the default render budget
ENVELOPE_MIN_INSTANCES = 512
PASS_CAMERA = 13     # the per-pass table's view (the heavy grazing one)
# the columns of ``Steady.summary``, one row a frame
SUMMARY = ("finite", "coverage", "overflow_mask", "num_selected",
           "num_instances", "num_work_items")


def frame_size(mode: str):
    """(width, height): 3840x2176 for 4k and envelope, else 1920x1152
    (1080p padded to whole 128-px supertile rows)."""
    return (3840, 2176) if mode in ("4k", "envelope") else (1920, 1152)


def default_quant(mode: str) -> float:
    """bench.py's ``--quant`` default: 64 m cells at walking speed (the
    quality-first setting), else 256."""
    return 64.0 if mode == "mapwalk" else 256.0


def budgets(mode: str):
    """(max_active, max_work) of bench.py: the light view of the map modes
    selects up to 631 instances over the whole world, above the 512 that
    fit the main camera; 4K needs 2632 work items at camera 0; the
    envelope's four quadtrees and mapwalk's ground-height eye (4103-5441
    items in the main raster; bench.py's comment gives its camera 0's 4252
    to the light pass) need 6144. Counts: tests/workload_counts_jax.npz."""
    max_active = {"envelope": 1024}.get(
        mode, 768 if mode in MAP_MODES else 512)
    max_work = 4096 if frame_size(mode)[1] > 1200 else 2048
    if mode in ("envelope", "mapwalk"):
        max_work = 6144
    return max_active, max_work


def config(mode: str, quant: Optional[float] = None,
           shadow_res: Optional[int] = None) -> FrameConfig:
    """bench.py's FrameConfig of ``mode``."""
    _check_mode(mode)
    if mode == "envelope":
        ts = TerrainSettings(max_instances=4096, surface_size=2048,
                             world_size=4096)
    else:
        ts = TerrainSettings(max_instances=1024)
    width, height = frame_size(mode)
    return FrameConfig(
        width=width, height=height, terrain=ts,
        shadow_mode="map" if mode in MAP_MODES else "horizon",
        shadow_resolution=2048 if shadow_res is None else int(shadow_res),
        shadow_select="light" if mode in ("mapref", "mapcache") else "main",
        shadow_eye_quant=(float(default_quant(mode) if quant is None
                                else quant)
                          if mode in QUANT_MODES else 0.0))


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {', '.join(MODES)}")


def _ground_path(hm: np.ndarray, world_size: float, points) -> np.ndarray:
    """(x, terrain height at the integer texel under (x, z) plus the eye
    height, z) for each ``(x, z, above)``, in float64 as bench.py computes
    them, then float32."""
    res = hm.shape[0]
    out = []
    for x, z, above in points:
        u = int(np.clip((x / world_size + 0.5) * (res - 1), 0, res - 1))
        v = int(np.clip((z / world_size + 0.5) * (res - 1), 0, res - 1))
        out.append((x, float(hm[v, u]) * MAX_HEIGHT + above, z))
    return np.asarray(out, np.float32)


def cameras(mode: str, heightmap: torch.Tensor, world_size: float
            ) -> Camera:
    """The mode's 64 cameras on the heightmap's device (bench.py:159-228):
    the flythrough; ``envelope``'s eye fixed 800 m over the four quadtrees'
    seam with the gaze orbiting at 60 m; ``mapwalk``'s walk at 2 m a frame,
    2 m above the terrain; ``ground``'s 160 m ring 2.5 m above it, looking
    ahead along the ground. The heights of the last two are read at
    integer texels, as bench.py does in numpy."""
    dev = heightmap.device
    n = N_CAMERAS
    if mode not in ("envelope", "mapwalk", "ground"):
        return flythrough(n, heightmap=heightmap, max_height=MAX_HEIGHT,
                          world_size=world_size)
    up = torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float32,
                      device=dev).repeat(n, 1)
    if mode == "envelope":
        # on the host: the card's cos and sin round otherwise
        ang = torch.from_numpy(
            2.0 * np.pi * np.arange(n, dtype=np.float32) / 64.0)
        eye = torch.tensor([[0.0, 800.0, 0.0]], dtype=torch.float32,
                           device=dev).repeat(n, 1)
        target = torch.stack([60.0 * torch.cos(ang), torch.zeros_like(ang),
                              60.0 * torch.sin(ang)], dim=-1)
        return Camera(eye=eye, target=target.to(dev), up=up)
    hm = heightmap.cpu().numpy()
    # bench.py walks mapwalk's path over the 2048 m world (its
    # TerrainSettings' world_size)
    if mode == "mapwalk":
        eye = _ground_path(hm, float(world_size),
                           [(-60.0 + 2.0 * i, 40.0 + 0.35 * i, 2.0)
                            for i in range(n)])
        target = eye + np.asarray([[40.0, -2.0, 25.0]], np.float32)
    else:
        ang = [2.0 * np.pi * i / 64.0 for i in range(n)]
        eye = _ground_path(hm, float(world_size),
                           [(160.0 * np.cos(a), 160.0 * np.sin(a), 2.5)
                            for a in ang])
        look = np.asarray([(np.cos(a + 0.6), np.sin(a + 0.6)) for a in ang],
                          np.float32)
        target = eye + np.stack([look[:, 0] * 50.0, np.zeros(n, np.float32),
                                 look[:, 1] * 50.0], axis=-1)
    return Camera(eye=torch.from_numpy(eye).to(dev),
                  target=torch.from_numpy(target.astype(np.float32)).to(dev),
                  up=up)


def build(mode: str = "1080p", device=None, quant: Optional[float] = None,
          shadow_res: Optional[int] = None):
    """(renderer, params, cameras) of ``mode`` as bench.py's ``build()``
    makes them: ``procedural_heightmap(256)``, its albedo, the
    ``Scene.default()`` boot cube, ``budgets(mode)``. On the CUDA device
    unless ``device`` names another; without a card it raises, as
    ``Renderer`` does."""
    _check_mode(mode)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "workloads.build renders on the CUDA device by default and "
                "none is available; pass device=\"cpu\" to build on the CPU")
        device = "cuda"
    device = torch.device(device)
    cfg = config(mode, quant, shadow_res)
    hm = hmod.procedural_heightmap(256, device=device)
    max_active, max_work = budgets(mode)
    r = Renderer(cfg, hm, hmod.procedural_albedo(hm), max_work=max_work,
                 max_active=max_active, scene=Scene.default(device),
                 device=device)
    params = FrameParams.default(r.light, device)
    return r, params, cameras(mode, hm, cfg.terrain.world_size)


def probe(renderer: Renderer, params: FrameParams, cams: Camera,
          mode: str) -> FrameOutput:
    """bench.py's probe (bench.py:339-358): camera 0 rendered inline must
    not overflow, and in ``envelope`` must select more than
    ENVELOPE_MIN_INSTANCES instances. Raises a RuntimeError with the counts
    against their budgets; returns the frame."""
    out = renderer.render(cams.frame(0), params)
    if bool(out.overflow):
        raise RuntimeError(
            f"{mode}: overflow at camera 0: {overflow_message(out, renderer)} "
            f"(work items {int(out.num_work_items)}/{renderer.max_work}, "
            f"instances {int(out.num_selected)}/{renderer.max_active})")
    if mode == "envelope" and int(out.num_instances) <= ENVELOPE_MIN_INSTANCES:
        raise RuntimeError(
            f"envelope: camera 0 selects {int(out.num_instances)} instances, "
            f"not more than {ENVELOPE_MIN_INSTANCES}")
    return out


def crossing_frames(cams: Camera, quant: float) -> List[int]:
    """The frames whose eye lies in another ``quant`` cell than the frame
    before's (bench.py:250-254)."""
    cells = np.floor(cams.eye.cpu().numpy().astype(np.float32)
                     / np.float32(quant))
    moved = np.abs(np.diff(cells, axis=0)).sum(axis=1) > 0
    return (np.nonzero(moved)[0] + 1).tolist()


def cell_crossings(cams: Camera, quant: float) -> int:
    """The quantized-eye cache's misses after its fill: bench.py's
    ``n_miss`` less one."""
    return len(crossing_frames(cams, quant))


class Steady(NamedTuple):
    """What ``steady_frames`` returns."""

    frames: Dict[int, FrameOutput]   # the frames asked for by ``keep``
    summary: np.ndarray              # (n, len(SUMMARY)), one row a frame
    light_rasters: int               # light views rastered in the loop
    ms: Optional[List[float]]        # CUDA-event ms a frame (None off-card)


def _summary(out: FrameOutput) -> torch.Tensor:
    return torch.stack([
        (torch.isfinite(out.ldr).all() & torch.isfinite(out.hdr).all()
         ).float(),
        (out.prim_id >= 0).float().mean(), out.overflow_mask.float(),
        out.num_selected.float(), out.num_instances.float(),
        out.num_work_items.float()])


def steady_frames(renderer: Renderer, params: FrameParams, cams: Camera,
                  mode: str, n: int = N_CAMERAS, keep=()) -> Steady:
    """Cameras 0..n-1 in order, each rendered once with the cache a user's
    loop keeps (bench.py:235-311, ``App.run_flythrough``):

    * horizon modes with a scene: ``cached_horizon_prepass`` once;
    * ``mapcache``: ``cached_shadow_prepass`` once, its light-eye map for
      every frame;
    * ``mapsnap``, ``mapwalk``: ``cached_shadow_prepass(camera_pos=eye)``
      every frame, which rasters the light view again exactly when the eye
      enters another cell; the first cell's map fills the cache before the
      loop;
    * ``map``, ``mapref``: no cache, a light pass inside every frame.

    The caches start empty (``reload_pipelines``). On the card each frame's
    time, cache lookup included, is taken with CUDA events; the fills
    before the loop are not in it. ``keep``: the frames whose outputs to
    return."""
    _check_mode(mode)
    renderer.reload_pipelines()
    cuda = renderer.device.type == "cuda"
    pre = frame_prepass(renderer, params, cams.eye[0], mode)   # the fill
    rasters = int(mode == "mapcache" or mode in QUANT_MODES)
    frames, rows, events = {}, [], []
    for i in range(n):
        cam = cams.frame(i)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        if mode in QUANT_MODES:
            last, pre = pre, frame_prepass(renderer, params, cam.eye, mode)
            rasters += pre is not last
        elif mode in ("map", "mapref"):
            rasters += 1
        out = renderer.render(cam, params, shadow_prepass=pre)
        if cuda:
            end.record()
            events.append((start, end))
        rows.append(_summary(out))
        if i in keep:
            frames[i] = out
    summary = torch.stack(rows).cpu().numpy().astype(np.float64)
    ms = [s.elapsed_time(e) for s, e in events] if cuda else None
    return Steady(frames=frames, summary=summary, light_rasters=rasters,
                  ms=ms)


def frame_prepass(renderer: Renderer, params: FrameParams, eye, mode: str):
    """The prepass ``steady_frames`` hands the frame at ``eye``, from the
    renderer's cache (None where the frame runs its shadow phase
    inline)."""
    if mode == "mapcache":
        return renderer.cached_shadow_prepass(params)
    if mode in QUANT_MODES:
        return renderer.cached_shadow_prepass(params, camera_pos=eye)
    if mode not in MAP_MODES and renderer.scene_transforms is not None:
        return renderer.cached_horizon_prepass(params)
    return None


def raster_terms(renderer: Renderer, params: FrameParams, cam: Camera,
                 mode: str) -> Dict[str, int]:
    """Kernel B1's input at ``cam``: its work items, the valid triangles
    of the packed instances (a non-empty pixel bbox) and the (triangle,
    pixel) pairs its block test evaluates (``block_pair_rects``)."""
    cfg = renderer.config
    packed, work = renderer.raster_inputs(
        cam, params, frame_prepass(renderer, params, cam.eye, mode))
    return {
        "work_items": int(work.num_items),
        "valid_tris": int((packed.vis[..., 12] < raster_cuda.F32_FAR).sum()),
        "evaluated_pairs": int(raster_cuda.block_pair_rects(
            packed.vis, work, cfg.width, cfg.height,
            cfg.raster.tile_w).cnt.sum()),
    }


def _corr(a: np.ndarray, b: np.ndarray) -> Optional[float]:
    """Pearson correlation, None where either side is constant."""
    if a.std() == 0.0 or b.std() == 0.0:
        return None
    return float(np.corrcoef(a, b)[0, 1])


def camera_stats(renderer: Renderer, params: FrameParams, cams: Camera,
                 mode: str, steady: Steady, slowest: int = 5) -> dict:
    """``scripts/tail.py``'s table for the port (tail.py:57-111): per
    camera of ``steady`` the frame's ms, selected instances (capped, as
    the frame reports them), work items, valid triangles and the pairs
    kernel B1 evaluates (``raster_terms``; in place of the TPU kernel's
    compaction rounds); then the mean, p50 and max ms, the ``slowest``
    cameras and each term's correlation with the ms. Without times (off
    the card) only the terms."""
    col = {k: j for j, k in enumerate(SUMMARY)}
    rows = []
    for i in range(steady.summary.shape[0]):
        row = {"camera": i,
               "instances": int(steady.summary[i, col["num_instances"]])}
        row.update(raster_terms(renderer, params, cams.frame(i), mode))
        if steady.ms is not None:
            row["ms"] = steady.ms[i]
        rows.append(row)
    stats = {"cameras": rows}
    if steady.ms is None:
        return stats
    ms = np.asarray(steady.ms, np.float64)
    order = np.argsort(-ms, kind="stable")[:slowest]
    stats.update({
        "mean_ms": float(ms.mean()), "p50_ms": float(np.median(ms)),
        "max_ms": float(ms.max()),
        "slowest": [[int(i), float(ms[i])] for i in order],
        "corr": {k: _corr(ms, np.asarray([r[k] for r in rows], np.float64))
                 for k in ("instances", "work_items", "valid_tris",
                           "evaluated_pairs")},
    })
    return stats


def pass_table(renderer: Renderer, cam: Camera):
    """``App.profile_passes`` of this renderer at ``cam`` (the PassTimer),
    as bench.py's 4K table (bench.py:368-384) and ``scripts/passes.py``
    time the JAX App's."""
    from vrenderer_tpu_torch.app import App

    app = App(renderer.config, scene=Scene.default(renderer.device),
              device=renderer.device)
    app.renderer = renderer
    return app.profile_passes(cam)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vrenderer_tpu_torch.workloads",
        description="Drive one of the JAX bench's workload modes through "
                    "the port on the card.")
    ap.add_argument("--mode", default="1080p", choices=MODES)
    ap.add_argument("--quant", type=float, default=None,
                    help="quantized-eye cell (m) of mapsnap/mapwalk")
    ap.add_argument("--shadowres", type=int, default=None,
                    help="light-map resolution of the map modes")
    ap.add_argument("--frames", type=int, default=N_CAMERAS,
                    help=f"cameras of the steady loop (at most {N_CAMERAS})")
    ap.add_argument("--tail", action="store_true",
                    help="one line a camera and its statistics")
    ap.add_argument("--passes", action="store_true",
                    help="the App.profile_passes table of the mode")
    args = ap.parse_args(argv)
    if not 1 <= args.frames <= N_CAMERAS:
        ap.error(f"--frames must be 1-{N_CAMERAS}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    r, params, cams = build(args.mode, quant=args.quant,
                            shadow_res=args.shadowres)
    cfg = r.config
    out = probe(r, params, cams, args.mode)
    print(f"{args.mode}: {cfg.width}x{cfg.height}, shadow {cfg.shadow_mode}"
          f" (res {cfg.shadow_resolution}, select {cfg.shadow_select}, quant"
          f" {cfg.shadow_eye_quant}), max_active {r.max_active}, max_work "
          f"{r.max_work}; {torch.cuda.get_device_name(r.device)}")
    print(f"probe camera 0: {int(out.num_instances)} instances, "
          f"{int(out.num_work_items)} work items, no overflow")
    steady = steady_frames(r, params, cams, args.mode, n=args.frames)
    col = {k: j for j, k in enumerate(SUMMARY)}
    s = steady.summary
    crossings = (f", {cell_crossings(cams, cfg.shadow_eye_quant)} cell "
                 f"crossings" if args.mode in QUANT_MODES else "")
    print(f"steady loop: {args.frames} frames, light rasters "
          f"{steady.light_rasters}{crossings}; overflow at "
          f"{int((s[:, col['overflow_mask']] != 0).sum())} frames; "
          f"non-finite at {int((s[:, col['finite']] != 1).sum())}")
    if args.tail:
        st = camera_stats(r, params, cams, args.mode, steady)
        for row in st["cameras"]:
            print(f"cam {row['camera']:2d}: {row['ms']:8.3f} ms  inst "
                  f"{row['instances']:4d} items {row['work_items']:5d} tris "
                  f"{row['valid_tris']:8d} pairs {row['evaluated_pairs']:9d}")
        print(f"mean {st['mean_ms']:.3f} ms, p50 {st['p50_ms']:.3f}, max "
              f"{st['max_ms']:.3f}; slowest "
              + ", ".join(f"cam {i} {m:.3f}" for i, m in st["slowest"]))
        print("; ".join(f"corr(ms, {k}) = "
                        + ("n/a" if v is None else f"{v:+.3f}")
                        for k, v in st["corr"].items()))
    if args.passes:
        print(f"per-pass ms at camera {PASS_CAMERA} (median of 10 calls, "
              f"CUDA events):")
        print(pass_table(r, cams.frame(PASS_CAMERA)).table())
    return 0


if __name__ == "__main__":
    sys.exit(main())
