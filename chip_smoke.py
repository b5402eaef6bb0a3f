#!/usr/bin/env python3
"""Drive the PyTorch port (``vrenderer_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line and raising on failure:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 is switched off for matmuls and cuDNN, since the JAX
   package runs its matrix products in full float32 (Precision.HIGHEST);
2. build: nvcc compiles ``vrenderer_tpu_torch/csrc`` (seconds printed);
3. kernel vs plain: the CUDA rasterizer against its plain PyTorch version
   on the card at the 1080p main path's inputs (flythrough cameras 0 and 13,
   13 being the heavy grazing view): ids and z equal, attrs within 1e-5,
   both timed with CUDA events;
4. golden frame: the 256x128 frame of tests/test_golden.py rendered
   through the kernel, held to the stored frames;
5. horizon path: the 1080p horizon-shadow flythrough with the boot cube
   and the cached horizon prepass, all 64 cameras, every frame finite,
   covered in (0, 1) and without overflow; CUDA-event frame times;
6. depth kernel vs plain: kernel B2 against its plain version and against
   kernel B1's z at the map cell's light-pass inputs (2048x2048, cameras 0
   and 13): z bitwise equal to both, both timed with CUDA events; then
   kernel B1 against its plain version at the map path's main-raster
   inputs (768 + 1 instance slots in the light selection's order, the
   membership mask leaving shared slots invalid), as in phase 3;
7. map golden frame: the 256x128 map-mode frame of
   tests/test_torch_map_frame.py, held to the op-by-op JAX frame and light
   passes (camera eye and default eye) stored in
   tests/golden_map_frame_unfused.npz;
8. map path: the 1080p map-shadow flythrough (bench.py --mode map: light
   pass from the main eye at 2048x2048, geometry shared with the main
   pass), all 64 cameras and a warm-up frame, every frame finite, covered
   in (0, 1) and without overflow (bits 1, 2 and 4); CUDA-event frame
   times;
9. cached map variant (bench.py --mode mapcache: light-eye selection and
   the cached prepass): 8 cameras bit-identical to inline frames, one
   light raster for the cached loop, ``render_shadow_depth`` equal to the
   cached map.

Each path's kernel launches are counted from 0 just before it runs. Then
one JSON line with each kernel's launches, error and times on the map
path (this slice's main path; B1's horizon-path numbers are in phase 3's
lines), the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it raises and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

WIDTH, HEIGHT = 1920, 1152          # bench.py's 1080p frame (9 supertiles)
MAX_ACTIVE, MAX_WORK = 512, 2048    # bench.py's horizon-mode budgets
MAP_MAX_ACTIVE = 768                # bench.py's map-mode render budget
SHADOW_RES = 2048                   # bench.py's light-map resolution
KERNEL_CAMERAS = (0, 13)
CACHED_CAMERAS = 8
ATTR_TOL = 1e-5   # kernel and plain round every plane op the same way


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the current stream (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bench_renderer(device, max_active=MAX_ACTIVE, **cfg_kw):
    """A bench.py renderer, parameters and cameras (bench.py:97-159);
    ``cfg_kw`` selects the shadow mode."""
    from vrenderer_tpu_torch.camera import flythrough
    from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings
    from vrenderer_tpu_torch.models.scene import Scene
    from vrenderer_tpu_torch.renderer import FrameParams, Renderer
    from vrenderer_tpu_torch.terrain import heightmap as hmod

    ts = TerrainSettings(max_instances=1024)
    cfg = FrameConfig(width=WIDTH, height=HEIGHT, terrain=ts, **cfg_kw)
    hm = hmod.procedural_heightmap(256, device=device)
    alb = hmod.procedural_albedo(hm)
    r = Renderer(cfg, hm, alb, max_work=MAX_WORK, max_active=max_active,
                 scene=Scene.default(device), device=device)
    params = FrameParams.default(r.light, device)
    cams = flythrough(64, heightmap=hm, max_height=400.0,
                      world_size=ts.world_size)
    return r, params, cams


def phase_kernel(name, r, params, prepass, cams) -> dict:
    """Kernel B1 against its plain version at the inputs the ``name`` path
    gives it."""
    import torch

    from vrenderer_tpu_torch.ops import raster_cuda

    cfg = r.config
    args = (cfg.width, cfg.height, cfg.raster.tile_w)
    errs, ms, plain_ms = [], [], []
    for i in KERNEL_CAMERAS:
        packed, work = r.raster_inputs(cams.frame(i), params, prepass)
        ref = raster_cuda.rasterize_plain(packed, work, *args)
        before = raster_cuda.rasterize.launches
        out = raster_cuda.rasterize(packed, work, *args)
        torch.cuda.synchronize()
        if raster_cuda.rasterize.launches != before + 1:
            raise RuntimeError("the raster wrapper did not count its launch")
        if not torch.equal(out[1], ref[1]):
            n = int((out[1] != ref[1]).sum())
            raise RuntimeError(f"camera {i}: {n} prim ids differ from plain")
        if not torch.equal(out[0], ref[0]):
            raise RuntimeError(f"camera {i}: z differs from plain")
        err = float((out[2] - ref[2]).abs().max())
        if not err <= ATTR_TOL:
            raise RuntimeError(f"camera {i}: attrs differ by {err}")
        k_ms = cuda_ms(lambda: raster_cuda.rasterize(packed, work, *args), 20)
        p_ms = cuda_ms(
            lambda: raster_cuda.rasterize_plain(packed, work, *args), 3)
        covered = float((out[1] >= 0).float().mean())
        log(f"kernel ({name} path) camera {i}: ids/z equal, attrs max abs "
            f"err {err:.3g}, instance slots {packed.vis.shape[0]}, work "
            f"items {int(work.num_items)}, covered {covered:.4f}, kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms")
        errs.append(err)
        ms.append(k_ms)
        plain_ms.append(p_ms)
    return {"max_abs_err": max(errs), "ms": float(np.mean(ms)),
            "plain_ms": float(np.mean(plain_ms))}


def phase_golden(device) -> None:
    """tests/test_golden.py's frame through the kernel, held to the stored
    frames (see tests/test_torch_frame.py for the bounds' reasons)."""
    import torch

    from vrenderer_tpu_torch.camera import Camera
    from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings
    from vrenderer_tpu_torch.ops import raster_cuda
    from vrenderer_tpu_torch.renderer import FrameParams, Renderer
    from vrenderer_tpu_torch.terrain import heightmap as hmod

    cfg = FrameConfig(width=256, height=128, terrain=TerrainSettings(
        surface_size=64, world_size=64, max_instances=64, grid_size=8))
    hm = hmod.procedural_heightmap(64, seed=7, device=device)
    r = Renderer(cfg, hm, hmod.procedural_albedo(hm), device=device)

    def v(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    cam = Camera(eye=v([0.0, 25.0, 45.0]), target=v([0.0, 0.0, 0.0]),
                 up=v([0.0, 1.0, 0.0]))
    before = raster_cuda.rasterize.launches
    out = r.render(cam, FrameParams.default(device=device)._replace(
        max_height=v(12.0)))
    torch.cuda.synchronize()
    if raster_cuda.rasterize.launches != before + 1:
        raise RuntimeError("the golden frame did not launch the kernel")
    ldr = out.ldr.cpu().numpy()
    prim = out.prim_id.cpu().numpy()
    golden = np.load(REPO / "tests" / "golden_frame.npy").astype(np.float32)
    ref = np.load(REPO / "tests" / "golden_frame_unfused.npz")
    d = np.abs(ldr - golden)
    du = np.abs(ldr - ref["ldr"].astype(np.float32))
    cov = float((prim >= 0).mean())
    same = prim == ref["prim_id"]
    log(f"golden frame: vs golden_frame.npy max {d.max():.4g} mean "
        f"{d.mean():.4g} ({int((d.max(-1) >= 5e-3).sum())} px >= 5e-3); "
        f"vs op-by-op JAX frame max {du.max():.4g} (same owner "
        f"{du[same].max():.4g}) mean {du.mean():.4g}, prim ids equal "
        f"{same.mean():.6f}; coverage {cov:.6f}; "
        f"prim[64,128]={prim[64, 128]} prim[100,200]={prim[100, 200]}")
    if not (d.mean() < 5e-4 and abs(cov - 0.552856) <= 0.002
            and prim[64, 128] == 2144 and prim[100, 200] == 3589):
        raise RuntimeError("golden frame outside test_golden.py's bounds")
    # the card's exp/pow/sin and its matmul sums round in other last bits
    # than the CPU's: a silhouette pixel may change owner, hence the count;
    # where the owner agrees the value bound holds
    if not (same.mean() >= 0.999 and du[same].max() < 5e-3):
        raise RuntimeError("golden frame differs from the op-by-op JAX frame")


def reset_launches() -> None:
    from vrenderer_tpu_torch.ops import raster_cuda

    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize_depth.launches = 0


def read_launches() -> dict:
    from vrenderer_tpu_torch.ops import raster_cuda

    return {"raster": raster_cuda.rasterize.launches,
            "raster_depth": raster_cuda.rasterize_depth.launches}


def phase_flythrough(name, r, params, cams, prepass=None):
    """All 64 flythrough frames after a warm-up frame; returns the
    CUDA-event frame times and the kernel launches of the run."""
    import torch

    reset_launches()
    r.render(cams.frame(0), params, shadow_prepass=prepass)   # warm-up
    times, stats = [], []
    for i in range(cams.eye.shape[0]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = r.render(cams.frame(i), params, shadow_prepass=prepass)
        end.record()
        stats.append(torch.stack([
            torch.isfinite(out.ldr).all().float(),
            torch.isfinite(out.hdr).all().float(),
            (out.prim_id >= 0).float().mean(),
            out.overflow_mask.float(),
            out.num_work_items.float(),
            out.num_instances.float(),
        ]))
        times.append((start, end))
    torch.cuda.synchronize()
    launches = read_launches()
    ms = [s.elapsed_time(e) for s, e in times]
    st = torch.stack(stats).cpu().numpy()
    for i, (fin_l, fin_h, cov, mask, n_work, n_inst) in enumerate(st):
        if not (fin_l == 1 and fin_h == 1 and 0.0 < cov < 1.0 and mask == 0
                and n_work <= r.max_work):
            raise RuntimeError(
                f"{name} frame {i}: finite ldr/hdr {bool(fin_l)}/"
                f"{bool(fin_h)}, coverage {cov}, overflow mask {int(mask)}, "
                f"work items {int(n_work)}, instances {int(n_inst)} "
                f"(max_work {r.max_work}, max_active {r.max_active})")
    log(f"{name} path: {len(ms)} frames finite, no overflow; coverage "
        f"{st[:, 2].min():.4f}-{st[:, 2].max():.4f}, work items "
        f"{int(st[:, 4].min())}-{int(st[:, 4].max())}, instances "
        f"{int(st[:, 5].min())}-{int(st[:, 5].max())}; launches {launches}")
    return ms, launches


def phase_depth_kernel(r, params, cams) -> dict:
    """Kernel B2 against its plain version and kernel B1's z at the map
    cell's light-pass inputs."""
    import torch

    from vrenderer_tpu_torch.ops import raster_cuda

    res = r.config.shadow_resolution
    args = (res, res, r.config.raster.tile_w)
    errs, ms, plain_ms = [], [], []
    for i in KERNEL_CAMERAS:
        vis, work = r.light_raster_inputs(cams.frame(i), params)
        ref = raster_cuda.rasterize_depth_plain(vis, work, *args)
        before = raster_cuda.rasterize_depth.launches
        z = raster_cuda.rasterize_depth(vis, work, *args)
        torch.cuda.synchronize()
        if raster_cuda.rasterize_depth.launches != before + 1:
            raise RuntimeError("the depth wrapper did not count its launch")
        if not torch.equal(z, ref):
            n = int((z != ref).sum())
            raise RuntimeError(f"camera {i}: {n} depth pixels differ from "
                               f"plain")
        coef = torch.zeros(vis.shape[:2] + (raster_cuda.NUM_COEF,),
                           device=vis.device)
        z_b1 = raster_cuda.rasterize(raster_cuda.PackedTris(vis, coef), work,
                                     *args)[0]
        if not torch.equal(z, z_b1):
            raise RuntimeError(f"camera {i}: depth differs from B1's z")
        if not bool(torch.all((z < 2.0) | (z == raster_cuda.F32_FAR))):
            raise RuntimeError(f"camera {i}: background is not F32_FAR")
        err = float((z - ref).abs().max())
        k_ms = cuda_ms(lambda: raster_cuda.rasterize_depth(vis, work, *args),
                       20)
        p_ms = cuda_ms(
            lambda: raster_cuda.rasterize_depth_plain(vis, work, *args), 3)
        covered = float((z < 2.0).float().mean())
        log(f"depth kernel camera {i}: z equal to plain and to B1, work "
            f"items {int(work.num_items)} (max_work {r.max_work}), covered "
            f"{covered:.4f}, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        errs.append(err)
        ms.append(k_ms)
        plain_ms.append(p_ms)
    return {"max_abs_err": max(errs), "ms": float(np.mean(ms)),
            "plain_ms": float(np.mean(plain_ms))}


def map_golden_renderer(device):
    """The renderer of the map golden frame (tests/test_torch_map_frame.py
    holds it to the same file on the CPU): the small terrain at 256x128
    with a 128x128 light map and a cube in view."""
    import torch

    from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings
    from vrenderer_tpu_torch.models import mesh, scene
    from vrenderer_tpu_torch.renderer import Renderer
    from vrenderer_tpu_torch.terrain import heightmap as hmod
    from vrenderer_tpu_torch.utils import math3d

    cfg = FrameConfig(width=256, height=128, terrain=TerrainSettings(
        surface_size=64, world_size=64, max_instances=64, grid_size=8),
        shadow_mode="map", shadow_resolution=128)
    hm = hmod.procedural_heightmap(64, seed=7, device=device)
    cube = scene.MeshInstance(
        mesh=mesh.cube(6.0, color=(0.9, 0.05, 0.05), device=device),
        transform=math3d.affine_translation(torch.tensor(
            [4.0, 17.0, 6.0], dtype=torch.float32, device=device)))
    return Renderer(cfg, hm, hmod.procedural_albedo(hm),
                    scene=scene.Scene(instances=[cube]), device=device)


def phase_map_golden(device) -> None:
    """The map golden frame (bounds and their reasons in
    tests/test_torch_map_frame.py): through the stored JAX light pass, the
    frame bounds of phase 4; through the card's own light pass (kernel
    B2), the covered and cube pixels, and the light map's coverage and
    heights."""
    import torch

    from vrenderer_tpu_torch import convert
    from vrenderer_tpu_torch.camera import Camera
    from vrenderer_tpu_torch.ops import raster_cuda
    from vrenderer_tpu_torch.renderer import FrameParams

    def v(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    g = np.load(REPO / "tests" / "golden_map_frame_unfused.npz")
    r = map_golden_renderer(device)
    cam = Camera(eye=v([0.0, 25.0, 45.0]), target=v([0.0, 0.0, 0.0]),
                 up=v([0.0, 1.0, 0.0]))
    params = FrameParams.default(device=device)._replace(max_height=v(12.0))
    n_terrain = 64 * r.config.terrain.tris_per_instance
    pre = convert.shadow_prepass(g["depth"], g["wtc"], g["z_range"],
                                 g["overflow"], g["shear"], device=device)
    out = r.render(cam, params, shadow_prepass=pre)
    prim = out.prim_id.cpu().numpy()
    same = prim == g["prim_id"]
    d = np.abs(out.ldr.cpu().numpy() - g["ldr"].astype(np.float32))
    before = read_launches()
    inline = r.render(cam, params)
    res = r.config.shadow_resolution
    depth = raster_cuda.rasterize_depth(*r.light_raster_inputs(cam, params),
                                        res, res).cpu().numpy()
    default = r.render_shadow_depth(params).cpu().numpy()
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in read_launches().items()}
    cls = [((inline.prim_id.cpu().numpy() >= lo) == (g["prim_id"] >= lo))
           .mean() for lo in (0, n_terrain)]
    d_inline = np.abs(inline.ldr.cpu().numpy() - g["ldr"].astype(np.float32))
    maps = []
    for z, ref in ((depth, g["depth"]), (default, g["depth_default"])):
        cov, ref_cov = z < 2.0, ref < 2.0
        dz = np.abs(z - ref)[cov & ref_cov]
        maps.append(((cov == ref_cov).mean(), (dz <= 1e-4).mean(),
                     np.median(dz)))
    log(f"map golden frame: via the stored light pass prim ids equal "
        f"{same.mean():.6f}, ldr max {d.max():.4g} (same owner "
        f"{d[same].max():.4g}) mean {d.mean():.4g}, cube px "
        f"{int((prim >= n_terrain).sum())}; inline covered/cube px agree "
        f"{cls[0]:.6f}/{cls[1]:.6f}, ldr mean {d_inline.mean():.4g}; light "
        f"map (camera eye / default eye) coverage agrees "
        f"{maps[0][0]:.6f}/{maps[1][0]:.6f}, |dz| <= 1e-4 on "
        f"{maps[0][1]:.4f}/{maps[1][1]:.4f} (median {maps[0][2]:.3g}/"
        f"{maps[1][2]:.3g}); launches {launched}")
    if launched != {"raster": 1, "raster_depth": 3}:
        raise RuntimeError("the inline map frame did not run both kernels")
    if not (same.mean() >= 0.999 and d[same].max() < 5e-3
            and d.mean() < 5e-4 and (prim >= n_terrain).sum() > 200):
        raise RuntimeError("map golden frame outside its bounds")
    # tests/test_torch_map_frame.py: the JAX package's jitted light pass
    # is within 1e-4 of its op-by-op pass at 96.6% / 93.8% of the pixels,
    # and its jitted frame 1.3e-3 off in mean ldr
    if not (min(cls) >= 0.999 and d_inline.mean() < 1e-3
            and all(c >= 0.999 and s >= 0.99 for c, s, _ in maps)):
        raise RuntimeError("the card's light pass differs from the golden")


def phase_map_cached(device, params, cams) -> None:
    """mapcache: the light-eye map rastered once serves every frame, and
    cached frames are bit-identical to inline ones."""
    import torch

    r, _, _ = bench_renderer(device, max_active=MAP_MAX_ACTIVE,
                             shadow_mode="map", shadow_resolution=SHADOW_RES,
                             shadow_select="light")
    reset_launches()
    cached = []
    for i in range(CACHED_CAMERAS):
        out = r.render(cams.frame(i), params,
                       shadow_prepass=r.cached_shadow_prepass(params))
        cached.append(out)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != {"raster": CACHED_CAMERAS, "raster_depth": 1}:
        raise RuntimeError(f"cached loop launches {launches}")
    for i, out in enumerate(cached):
        inline = r.render(cams.frame(i), params)
        for f in ("ldr", "hdr", "depth", "prim_id", "overflow_mask"):
            if not torch.equal(getattr(out, f), getattr(inline, f)):
                raise RuntimeError(f"cached frame {i}: {f} differs from the "
                                   f"inline frame")
        if int(out.overflow_mask) != 0:
            raise RuntimeError(f"cached frame {i}: overflow mask "
                               f"{int(out.overflow_mask)}")
    # the light-eye map depends on no camera: the standalone light view is
    # the cached one
    if not torch.equal(r.render_shadow_depth(params),
                       r.cached_shadow_prepass(params)[0]):
        raise RuntimeError("render_shadow_depth differs from the prepass")
    log(f"map cached variant: {CACHED_CAMERAS} cached frames bit-identical "
        f"to inline frames; cached loop launches {launches}; "
        f"render_shadow_depth equals the cached map")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run "
                         "needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    from vrenderer_tpu_torch.ops import _build

    card = nvidia_smi()
    log(f"environment: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
        f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    ptxas = [ln.split("info    : ")[-1] for ln in
             (lib.parent / "nvcc.log").read_text().splitlines()
             if "registers" in ln]
    log(f"build: {lib.relative_to(REPO)} in "
        f"{time.perf_counter() - t0:.1f} s; ptxas: {'; '.join(ptxas)}")

    r, params, cams = bench_renderer(device)
    prepass = r.cached_horizon_prepass(params)
    phase_kernel("horizon", r, params, prepass, cams)
    phase_golden(device)
    ms, launches = phase_flythrough("horizon", r, params, cams, prepass)
    # 64 frames + the warm-up frame (the prepass was cached before)
    if launches != {"raster": 65, "raster_depth": 0}:
        raise RuntimeError(f"horizon path launches {launches}")
    log(f"horizon frame times ({card}): mean {np.mean(ms):.3f} ms, p50 "
        f"{np.median(ms):.3f} ms, max {np.max(ms):.3f} ms over 64 frames "
        f"(CUDA events, 1920x1152)")
    del r

    rm, _, _ = bench_renderer(device, max_active=MAP_MAX_ACTIVE,
                              shadow_mode="map", shadow_resolution=SHADOW_RES)
    kern_d = phase_depth_kernel(rm, params, cams)
    kern = phase_kernel("map", rm, params, None, cams)
    phase_map_golden(device)
    map_ms, map_launches = phase_flythrough("map", rm, params, cams)
    if map_launches != {"raster": 65, "raster_depth": 65}:
        raise RuntimeError(f"map path launches {map_launches}")
    log(f"map frame times ({card}): mean {np.mean(map_ms):.3f} ms, p50 "
        f"{np.median(map_ms):.3f} ms, max {np.max(map_ms):.3f} ms over 64 "
        f"frames (CUDA events, 1920x1152, light map {SHADOW_RES}^2)")
    del rm
    phase_map_cached(device, params, cams)

    print(json.dumps({"kernels": [{
        "name": "raster",
        "route": "cuda",
        "source": "vrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "vrenderer_tpu/ops/raster_pallas.py:598",
        "launches": map_launches["raster"],
        **kern,
    }, {
        "name": "raster_depth",
        "route": "cuda",
        "source": "vrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "vrenderer_tpu/ops/raster_pallas.py:1121",
        "launches": map_launches["raster_depth"],
        **kern_d,
    }]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
