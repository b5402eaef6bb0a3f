"""Headless app shell: the reference's main.cpp (main.cpp:16-107) and the
PyTorch counterpart of ``vrenderer_tpu.app``.

``App`` builds the heightmap, the albedo, a ``Renderer``, a
``FrameProfiler`` and the frame parameters, then drives a scripted
flythrough the way the reference's loop does: eye adaptation every frame,
up to ``frames_in_flight`` frames dispatched before the oldest is fetched,
PNG dumps and a chrome trace. ``profile_passes`` times each pass under the
reference's counter names (the profiler HUD's, SURVEY.md section 5.1).
"""

from __future__ import annotations

import struct
import warnings
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vrenderer_tpu_torch.camera import Camera, flythrough
from vrenderer_tpu_torch.config import FrameConfig
from vrenderer_tpu_torch.ops import lighting, raster, raster_cuda, shadow
from vrenderer_tpu_torch.ops import vertex
from vrenderer_tpu_torch.profiler import FrameProfiler, PassTimer, active
from vrenderer_tpu_torch.renderer import (
    FrameParams, Renderer, overflow_message,
)
from vrenderer_tpu_torch.terrain import heightmap as hmod
from vrenderer_tpu_torch.terrain import quadtree
from vrenderer_tpu_torch.utils import math3d


def write_png(path: str, image01: np.ndarray):
    """Minimal RGB8 PNG writer (no external dependency): values clipped to
    [0, 1] and rounded to 8 bits, filter 0 on every row."""
    img = np.clip(np.asarray(image01), 0.0, 1.0)
    img = (img * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return (struct.pack(">I", len(data)) + c
                + struct.pack(">I", zlib.crc32(c)))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


@dataclass
class App:
    """Build everything (main.cpp) and drive frames. ``device=None`` means
    the CUDA device; without one the Renderer raises, so pass
    ``device="cpu"`` there."""

    config: FrameConfig
    heightmap_resolution: int = 256
    seed: int = 1234
    # "pallas" (the port's CUDA kernels) or "xla" (the dense oracle):
    # Renderer's raster_backend
    raster_backend: str = "pallas"
    # the boot scene (the reference loads Cube.gltf, main.cpp:89-95): a
    # models.scene.Scene or None
    scene: object = None
    device: object = None

    def __post_init__(self):
        if self.device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "App renders on the CUDA device by default and none is "
                    "available; pass device=\"cpu\" to render on the CPU")
            self.device = "cuda"
        self.device = torch.device(self.device)
        self.heightmap = hmod.procedural_heightmap(
            self.heightmap_resolution, self.seed, device=self.device)
        self.albedo = hmod.procedural_albedo(self.heightmap)
        self.renderer = Renderer(self.config, self.heightmap, self.albedo,
                                 raster_backend=self.raster_backend,
                                 scene=self.scene, device=self.device)
        self.profiler = FrameProfiler()
        self.params = FrameParams.default(device=self.device)
        self.adapt_history = []

    def run_flythrough(self, num_frames: int = 8,
                       dump_dir: Optional[str] = None,
                       trace_path: Optional[str] = None, adapt: bool = True,
                       dt: float = 1.0 / 60.0, frames_in_flight: int = 2):
        """The scripted flythrough with the reference loop's behaviours:

        * eye adaptation advances every frame unless ``adapt=False`` (the
          tonemapper's AdvanceFrame, Renderer.cpp:188-189); ``dt`` is its
          time step. The carry stays a device tensor, and
          ``adapt_history`` is fetched once, after the loop;
        * frame N+1 is dispatched before frame N is fetched, up to
          ``frames_in_flight`` frames (the reference's frameLatency=2,
          main.cpp:70). On the card each frame's ldr and overflow flag are
          copied to pinned host memory behind it on the stream; "Wait GPU"
          waits for that copy, so it waits for its own frame only. While
          the profiler records spans, the frame's ``num_selected`` and
          ``num_work_items`` ride in the flag's copy and are recorded as
          its ``Instances`` and ``Work items`` counters.

        Returns the frames' ``FrameOutput``s, on the device."""
        if frames_in_flight < 1:
            raise ValueError(f"frames_in_flight must be at least 1, got "
                             f"{frames_in_flight}")
        cfg = self.config
        r = self.renderer
        cams = flythrough(num_frames, world_size=cfg.terrain.world_size,
                          heightmap=self.heightmap,
                          max_height=float(self.params.max_height))
        # cached shadow prepasses, re-keyed every frame: map mode's
        # whole-world map under shadow_select="light" is camera-independent,
        # and a quantized main eye re-rasters on cell crossings; horizon
        # mode's mesh-occluder field and shadow line never depend on the
        # camera (bit-identical frames)
        use_shadow_cache = (
            cfg.shadow_mode == "map" and cfg.shadow_cache
            and (cfg.shadow_select == "light"
                 or (cfg.shadow_select == "main"
                     and cfg.shadow_eye_quant > 0.0)))
        use_horizon_cache = (cfg.shadow_mode == "horizon" and cfg.shadow_cache
                             and r._scene_obj is not None)
        on_card = self.device.type == "cuda"
        adapted_lum = torch.tensor(0.5, dtype=torch.float32,
                                   device=self.device)
        lum_trace = []
        # (frame index, its profiler frame, FrameOutput, ldr, flags, done);
        # flags: the overflow flag, or while counting (overflow, selected,
        # work items)
        in_flight = []
        outputs = []

        def retire(i, frame, out, ldr, flags, done):
            with self.profiler.scope("Wait GPU", frame=frame):
                if done is not None:
                    done.synchronize()
                ldr = ldr.numpy()
            overflow = flags
            if counting:
                overflow, selected, work = flags.tolist()
                self.profiler.count("Instances", selected, frame=frame)
                self.profiler.count("Work items", work, frame=frame)
            if bool(overflow):
                # the reference asserts on instance overflow
                # (TerrainPass.cpp:238): name the capacity that overflowed
                warnings.warn(f"frame {i}: {overflow_message(out, r)}")
            if dump_dir is not None:
                with self.profiler.scope("Present"):
                    write_png(f"{dump_dir}/frame_{i:04d}.png", ldr)
            outputs.append(out)

        with self.profiler.recording():
            counting = active() is self.profiler
            for i in range(num_frames):
                self.profiler.begin_frame()
                cam = cams.frame(i)
                prepass = None
                if use_shadow_cache:
                    with self.profiler.scope("ShadowMap"):
                        prepass = r.cached_shadow_prepass(self.params,
                                                          camera_pos=cam.eye)
                elif use_horizon_cache:
                    with self.profiler.scope("Terrain Shadow"):
                        prepass = r.cached_horizon_prepass(self.params)
                with self.profiler.scope("Render"):
                    if adapt:
                        out, adapted_lum = r.render_adaptive(
                            cam, self.params, adapted_lum, dt,
                            shadow_prepass=prepass)
                        lum_trace.append(adapted_lum)
                    else:
                        out = r.render(cam, self.params,
                                       shadow_prepass=prepass)
                    done = None
                    ldr, flags = out.ldr, out.overflow
                    if counting:
                        flags = torch.stack([flags, out.num_selected,
                                             out.num_work_items])
                    if on_card:
                        ldr = ldr.to("cpu", non_blocking=True)
                        flags = flags.to("cpu", non_blocking=True)
                        done = torch.cuda.Event()
                        done.record()
                in_flight.append((i, self.profiler.frame, out, ldr, flags,
                                  done))
                if len(in_flight) >= frames_in_flight:
                    retire(*in_flight.pop(0))
                self.profiler.end_frame()
            self.profiler.begin_frame()
            while in_flight:
                retire(*in_flight.pop(0))
            self.profiler.end_frame()
        if trace_path is not None:
            self.profiler.export_chrome_trace(trace_path)
        self.adapted_lum = adapted_lum
        self.adapt_history = (torch.stack(lum_trace).cpu().tolist()
                              if lum_trace else [])
        return outputs

    def window_title(self) -> str:
        """The title bar's average ms/frame and FPS
        (SetInformativeWindowTitle, Renderer.cpp:190)."""
        ms = self.profiler.average_frame_ms()
        fps = 1000.0 / ms if ms > 0 else 0.0
        return f"vrenderer_tpu {ms:.1f} ms/frame ({fps:.0f} FPS)"

    def profile_passes(self, camera: Optional[Camera] = None,
                       long: int = 10) -> PassTimer:
        """Per-pass milliseconds under the reference's counter names, each
        the median of ``long`` timed calls of the renderer's own pass
        functions (``PassTimer``):

        * map mode: "ShadowMap" (the light pass: selection, geometry, setup,
          binning, kernel B2) and "Cascade ShadowMap" (the light pass and
          the terrain's factors from the map); horizon mode: "Terrain
          Shadow" (with a scene, the mesh-top field and shadow line);
        * "TerrainPass::UpdateTransforms" (LOD selection), with a scene
          "Scene Refresh" (transforms applied) and "GBuffer fill" (the scene
          blocks' setup and packing);
        * "Terrain" (selection, vertex stage, setup, binning and kernel B1
          of terrain and scene), "Deferred Lighting", "ToneMapping", "Sky"
          and "GPU Frame" (one whole ``render``)."""
        cfg = self.config
        ts = cfg.terrain
        r = self.renderer
        dev = self.device
        cam = camera if camera is not None else Camera.default(dev)
        params = self.params
        vc = r._view(cam)
        wtc = vc["world_to_clip"]
        eye = vc["camera_pos"]
        timer = PassTimer(dev, long=long)
        with torch.no_grad():
            scene_wa = r._scene_wa(params)
            if cfg.shadow_mode == "map":
                timer.measure("ShadowMap", lambda: r._light_depth_pass(
                    params, eye, scene_wa))

                def full_shadow_phase():
                    depth_map, _, _, _, shear = r._light_depth_pass(
                        params, eye, scene_wa)
                    return r.shadow_field_from_map(depth_map, shear, params)

                timer.measure("Cascade ShadowMap", full_shadow_phase)
            elif r._scene_obj is not None:
                timer.measure("Terrain Shadow", lambda: r._horizon_fields(
                    params, r.scene_transforms))
            else:
                timer.measure("Terrain Shadow", lambda: (
                    shadow.horizon_shadow_field(
                        r.heightmap, params.max_height,
                        float(ts.world_size), params.light_direction)))
            timer.measure(
                "TerrainPass::UpdateTransforms",
                lambda: quadtree.select_all_surfaces(
                    ts, eye, math3d.frustum_planes(wtc), r.lod_ranges))
            if scene_wa is not None:
                timer.measure("Scene Refresh", lambda: r._scene_blocks(
                    r.scene_transforms, params.max_height))
                s_world, s_attrs = scene_wa
                n_blocks = s_world.shape[0]
                ones = torch.ones((n_blocks,), dtype=torch.bool, device=dev)
                timer.measure("GBuffer fill", lambda: raster_cuda.pack_setup(
                    raster.stack_components(raster.setup_components(
                        s_world, s_attrs, ones, r._scene_tri_idx, wtc,
                        cfg.width, cfg.height)), n_blocks))

            # the frame's shadow inputs; "Terrain" selects and vertex-stages
            # its own geometry, as a frame without map mode's sharing does
            sh = r._shadow_inputs(vc, params)._replace(instances=None,
                                                       vout=None)
            timer.measure("Terrain", lambda: r._terrain_pass(vc, params, sh))
            _, prim_id, attrs, _, _ = r._terrain_pass(vc, params, sh)
            covered = prim_id >= 0
            rays = r._view_rays(vc)

            def lighting_pass():
                return lighting.deferred_lighting(
                    attrs[..., vertex.ATTR_ALBEDO],
                    attrs[..., vertex.ATTR_NORMAL],
                    torch.clamp(attrs[..., vertex.ATTR_SHADOW], 0.0, 1.0),
                    covered, -rays, params.light_direction,
                    params.light_irradiance, params.light_color,
                    params.ambient_intensity)

            timer.measure("Deferred Lighting", lighting_pass)
            hdr = lighting_pass()
            timer.measure("ToneMapping",
                          lambda: lighting.tonemap(hdr, params.exposure))
            timer.measure("Sky", lambda: lighting.sky_color(
                rays, params.light_direction))
            timer.measure("GPU Frame", lambda: r.render(cam, params))
        return timer
