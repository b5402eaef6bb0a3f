"""Headless editor shell, the reference's Editor and RenderUI
(source/editor/Editor.cpp; Renderer::RenderUI, Renderer.cpp:456-514), as in
``vrenderer_tpu.editor``.

Without a window system each UI control is a command: the renderer
string with ms/frame and FPS, the frame-time plot's profiler exports, the
glTF open dialog, the settings panel (shader reload, terrain toggle, max
height, sun, ambient, exposure, the quadtree debug view, lock-view) and
the first-person and orbit cameras. A command changes ``FrameParams`` or
renderer state, and ``render`` draws a frame. Drive it interactively,
``python -m vrenderer_tpu_torch.editor`` (on the CUDA device), or with
``Editor.execute(line)``.
"""

from __future__ import annotations

import math
import os
import shlex
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from vrenderer_tpu_torch.camera import (
    Camera, FirstPersonController, OrbitController,
)
from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings

_HELP = """\
render [out.png]      render a frame (current camera/params)
fly N [dir]           render an N-frame flythrough to dir
camera X Y Z [TX TY TZ]  set eye (and target)
walk on|fly|off       first-person controller (walk pins to ground; fly
                      moves along the look direction)
step DT [KEYS] [MDX MDY]  one Animate tick: hold KEYS (wasdeq, uppercase
                      = sprint), mouse-look by (MDX, MDY) px
speed V               first-person move speed (m/s)
orbit on [D]          orbit controller around the current target at distance D
drag DX DY | zoom F   orbit the view / dolly the distance
light AZ EL           sun direction from azimuth/elevation deg
ambient V | exposure V | max-height V   set render params
terrain on|off        toggle the terrain pass
adapt on|off          eye adaptation across renders (default on)
debug-quadtree on|off node-id tint overlay
lock | unlock         freeze/unfreeze LOD selection
load PATH             load a glTF/GLB scene
move-instance I X Y Z translate scene instance I (no rebuild)
clear-scene           drop the scene
reload                shader-reload analog (drop the cached prepasses)
stats                 instances/coverage/ms of the last frame
fps                   window-title style avg ms + FPS
flamegraph [out.svg]  export the profiler HUD flame graph
trace [out.json]      export chrome://tracing JSON
shadow-depth [out]    render the light-view depth map
quit                  leave the shell"""


class Editor:
    """Command-driven editor session around an App. Without ``app`` it
    builds the JAX package's default (512x256, ``max_instances=1024``) on
    ``device``, the CUDA device unless another is given."""

    def __init__(self, app=None, out_dir: Optional[str] = None,
                 device=None):
        if app is None:
            from vrenderer_tpu_torch.app import App

            app = App(FrameConfig(width=512, height=256,
                                  terrain=TerrainSettings(max_instances=1024)),
                      device=device)
        self.app = app
        self.out_dir = out_dir or os.path.join(tempfile.gettempdir(),
                                               "vrt_editor")
        self.camera = Camera.default(app.device)
        self.fpc = None       # first-person controller ('walk on')
        self.orbit = None     # orbit controller ('orbit on')
        self.locked_instances = None
        self.last_output = None
        self.frame_counter = 0
        # eye adaptation advances across renders (the tonemapper's
        # AdvanceFrame, Renderer.cpp:188-189)
        self.adapt = True
        self.adapted_lum = 0.5
        self._last_render_t: Optional[float] = None
        os.makedirs(self.out_dir, exist_ok=True)

    # -- command surface ---------------------------------------------------

    def execute(self, line: str) -> str:
        """Run one command; returns the textual response."""
        parts = shlex.split(line)
        if not parts:
            return ""
        cmd, args = parts[0], parts[1:]
        fn = getattr(self, f"cmd_{cmd.replace('-', '_')}", None)
        if fn is None:
            return f"unknown command: {cmd} (try 'help')"
        try:
            return fn(*args) or "ok"
        except Exception as e:  # reported like the reference's log
            return f"error: {e}"

    def cmd_help(self):
        return _HELP

    def _vec(self, *v) -> torch.Tensor:
        return torch.tensor([float(x) for x in v], dtype=torch.float32,
                            device=self.app.device)

    def _scalar(self, v) -> torch.Tensor:
        return torch.tensor(float(v), dtype=torch.float32,
                            device=self.app.device)

    def _render(self):
        """One frame of the current camera and parameters, with eye
        adaptation over the wall time since the last render (clamped to
        0.5 s) unless it is off, and the frozen selection under lock-view.
        Waits for the frame by copying its ldr to the host."""
        app = self.app
        app.profiler.begin_frame()
        now = time.perf_counter()
        dt = min(now - (self._last_render_t or now - 1.0 / 30.0), 0.5)
        self._last_render_t = now
        with app.profiler.recording(), app.profiler.scope("Render"):
            if self.adapt:
                out, lum = app.renderer.render_adaptive(
                    self.camera, app.params, self.adapted_lum, dt,
                    instances=self.locked_instances)
                self.adapted_lum = float(lum)
            elif self.locked_instances is not None:
                out = app.renderer.render_locked(self.camera, app.params,
                                                 self.locked_instances)
            else:
                out = app.renderer.render(self.camera, app.params)
            out.ldr.cpu()   # the frame's time includes its device work
        app.profiler.end_frame()
        self.last_output = out
        self.frame_counter += 1
        return out

    def cmd_render(self, out_path: Optional[str] = None):
        from vrenderer_tpu_torch.app import write_png

        out = self._render()
        path = out_path or os.path.join(
            self.out_dir, f"frame_{self.frame_counter:04d}.png")
        write_png(path, out.ldr.cpu().numpy())
        ov = " OVERFLOW" if bool(out.overflow) else ""
        return (f"wrote {path} instances={int(out.num_instances)}"
                f" work={int(out.num_work_items)}{ov}")

    def cmd_fly(self, n: str = "4", dump: Optional[str] = None):
        outs = self.app.run_flythrough(num_frames=int(n),
                                       dump_dir=dump or self.out_dir)
        self.last_output = outs[-1]
        return f"rendered {len(outs)} frames to {dump or self.out_dir}"

    def cmd_camera(self, x, y, z, tx="0", ty="0", tz="0"):
        self.camera = Camera(eye=self._vec(x, y, z),
                             target=self._vec(tx, ty, tz),
                             up=self._vec(0.0, 1.0, 0.0))

    def cmd_walk(self, mode="on"):
        """First-person camera (the input surface of Renderer.cpp:149-181
        and Animate's integration): 'on' walks with the eye 1.8 m above the
        terrain, 'fly' flies, 'off' returns to the static camera."""
        if mode == "off":
            self.fpc = None
            return "first-person controller off"
        app = self.app
        self.orbit = None
        self.fpc = FirstPersonController(
            camera=self.camera, heightmap=app.heightmap,
            world_size=float(app.config.terrain.world_size),
            max_height=float(app.params.max_height), walk=(mode == "on"))
        self.camera = self.fpc.camera(app.device)
        e = self.fpc.pos
        return (f"{'walk' if mode == 'on' else 'fly'} mode at "
                f"({e[0]:.1f}, {e[1]:.1f}, {e[2]:.1f})")

    def cmd_step(self, dt, keys="", mdx="0", mdy="0"):
        """One Animate tick: hold KEYS for this step (wasdeq, uppercase
        sprints), apply a mouse-look delta, integrate the velocity."""
        fpc = self.fpc
        if fpc is None:
            return "no first-person controller (run 'walk on' first)"
        held = set()
        for ch in keys:
            if ch in "-.":
                continue
            if ch.isupper():
                held.add("shift")
            held.add(ch.lower())
        fpc._keys = held
        fpc.mouse_move(float(mdx), float(mdy))
        self.camera = fpc.animate(float(dt), self.app.device)
        e = fpc.pos
        v = float(np.linalg.norm(fpc.vel))
        return (f"eye ({e[0]:.2f}, {e[1]:.2f}, {e[2]:.2f}) speed {v:.2f} m/s "
                f"yaw {math.degrees(fpc.yaw):.1f} "
                f"pitch {math.degrees(fpc.pitch):.1f}")

    def cmd_speed(self, v):
        if self.fpc is None:
            return "no first-person controller (run 'walk on' first)"
        self.fpc.move_speed = float(v)

    def cmd_orbit(self, mode="on", dist=None):
        if mode == "off":
            self.orbit = None
            return "orbit controller off"
        self.fpc = None
        eye = self.camera.eye.cpu().numpy()
        tgt = self.camera.target.cpu().numpy()
        d = (float(dist) if dist is not None
             else float(np.linalg.norm(eye - tgt)))
        off = eye - tgt
        self.orbit = OrbitController(
            pivot=tgt, distance=d,
            yaw=math.atan2(float(off[2]), float(off[0])),
            pitch=math.asin(float(np.clip(off[1] / max(d, 1e-6), -1, 1))))
        self.camera = self.orbit.camera(self.app.device)
        return (f"orbiting ({tgt[0]:.1f}, {tgt[1]:.1f}, {tgt[2]:.1f}) at "
                f"{d:.1f}")

    def cmd_drag(self, dx, dy):
        if self.orbit is None:
            return "no orbit controller (run 'orbit on' first)"
        self.orbit.drag(float(dx), float(dy))
        self.camera = self.orbit.camera(self.app.device)

    def cmd_zoom(self, factor):
        if self.orbit is None:
            return "no orbit controller (run 'orbit on' first)"
        self.orbit.zoom(float(factor))
        self.camera = self.orbit.camera(self.app.device)
        return f"distance {self.orbit.distance:.1f}"

    def cmd_light(self, az, el):
        a, e = math.radians(float(az)), math.radians(float(el))
        d = self._vec(-math.cos(e) * math.cos(a), -math.sin(e),
                      -math.cos(e) * math.sin(a))
        self.app.params = self.app.params._replace(light_direction=d)

    def cmd_ambient(self, v):
        self.app.params = self.app.params._replace(
            ambient_intensity=self._scalar(v))

    def cmd_exposure(self, v):
        self.app.params = self.app.params._replace(exposure=self._scalar(v))

    def cmd_max_height(self, v):
        self.app.params = self.app.params._replace(
            max_height=self._scalar(v))

    def cmd_terrain(self, onoff):
        self.app.params = self.app.params._replace(
            render_terrain=self._scalar(1.0 if onoff == "on" else 0.0))

    def cmd_adapt(self, onoff):
        self.adapt = onoff == "on"
        return (f"eye adaptation {'on' if self.adapt else 'off'} "
                f"(lum={self.adapted_lum:.3f})")

    def cmd_debug_quadtree(self, onoff):
        self.app.params = self.app.params._replace(
            debug_quadtree=self._scalar(1.0 if onoff == "on" else 0.0))

    def cmd_lock(self):
        self.locked_instances = self.app.renderer.select(self.camera)
        return "LOD selection frozen (lock-view)"

    def cmd_unlock(self):
        self.locked_instances = None
        return "LOD selection live"

    def _rebuild_renderer(self, scene=None):
        """A new Renderer over the App's assets with the current backend
        and device (the scene's topology is static per Renderer)."""
        from vrenderer_tpu_torch.renderer import Renderer

        app = self.app
        app.renderer = Renderer(
            app.config, app.heightmap, app.albedo,
            raster_backend=app.renderer.raster_backend,
            interpret=app.renderer.interpret, scene=scene,
            device=app.device)

    def cmd_load(self, path):
        from vrenderer_tpu_torch.models.scene import load_gltf

        sc = load_gltf(path, device=self.app.device)
        self._rebuild_renderer(sc)
        return f"loaded {path}: {len(sc.instances)} instance(s)"

    def cmd_move_instance(self, idx, dx, dy, dz):
        """Translate scene instance ``idx`` by (dx, dy, dz) in place (the
        Scene::RefreshSceneGraph analog): the next frame picks it up with
        no Renderer rebuild."""
        r = self.app.renderer
        if r.scene_transforms is None:
            return "no scene loaded"
        i = int(idx)
        r.scene_transforms[i, 3] += self._vec(dx, dy, dz)
        p = r.scene_transforms[i, 3].cpu().numpy()
        return f"instance {i} origin now ({p[0]:g}, {p[1]:g}, {p[2]:g})"

    def cmd_clear_scene(self):
        self._rebuild_renderer()

    def cmd_reload(self):
        self.app.renderer.reload_pipelines()
        return "cached prepasses dropped; the next frame recomputes them"

    def cmd_stats(self):
        out = self.last_output
        if out is None:
            return "no frame rendered yet"
        cov = float((out.prim_id >= 0).float().mean())
        return (f"instances={int(out.num_instances)} "
                f"work_items={int(out.num_work_items)} "
                f"coverage={cov:.3f} overflow={bool(out.overflow)}")

    def cmd_fps(self):
        ms = self.app.profiler.average_frame_ms()
        fps = 1000.0 / ms if ms > 0 else 0.0
        # the window title (SetInformativeWindowTitle, Renderer.cpp:190)
        return f"vrenderer_tpu - {ms:.2f} ms/frame ({fps:.1f} FPS)"

    def cmd_flamegraph(self, out_path: Optional[str] = None):
        path = out_path or os.path.join(self.out_dir, "flame.svg")
        self.app.profiler.export_flamegraph_svg(path)
        return f"wrote {path}"

    def cmd_trace(self, out_path: Optional[str] = None):
        path = out_path or os.path.join(self.out_dir, "trace.json")
        self.app.profiler.export_chrome_trace(path)
        return f"wrote {path}"

    def cmd_shadow_depth(self, out_path: Optional[str] = None):
        from vrenderer_tpu_torch.app import write_png

        z = self.app.renderer.render_shadow_depth(self.app.params)
        z01 = torch.clamp(torch.where(z > 1e30, torch.ones_like(z), z),
                          0.0, 1.0).cpu().numpy()
        path = out_path or os.path.join(self.out_dir, "shadow_depth.png")
        write_png(path, np.repeat(z01[..., None], 3, axis=-1))
        return f"wrote {path}"

    def repl(self):  # pragma: no cover - interactive only
        print("vrenderer_tpu editor — 'help' for commands")
        while True:
            try:
                line = input("vrt> ")
            except EOFError:
                break
            if line.strip() in ("quit", "exit"):
                break
            resp = self.execute(line)
            if resp:
                print(resp)


if __name__ == "__main__":  # pragma: no cover
    Editor().repl()
