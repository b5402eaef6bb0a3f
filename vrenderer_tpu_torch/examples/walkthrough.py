"""Walkthrough: the first-person controller walks across the terrain
(the reference's FirstPersonCamera and Animate loop, Renderer.cpp:149-185)
and the App renders a frame each tick. Scripted input stands in for GLFW:
walk forward, look around, sprint the second half. Writes PNGs and prints
the window title's ms/frame.

    python -m vrenderer_tpu_torch.examples.walkthrough [outdir] [n] [--cpu]

On the CUDA device at 1920x1080 in the 2048 m world; with ``--cpu`` the
small 256x128 world of the tests.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from vrenderer_tpu_torch.app import App, write_png
from vrenderer_tpu_torch.camera import Camera, FirstPersonController
from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings


def walk(outdir: str, n: int = 8, device=None):
    """Render ``n`` walking frames into ``outdir``; returns the App."""
    os.makedirs(outdir, exist_ok=True)
    on_cpu = device is not None and torch.device(device).type == "cpu"
    cfg = FrameConfig() if not on_cpu else FrameConfig(
        width=256, height=128,
        terrain=TerrainSettings(surface_size=64, world_size=64,
                                max_instances=64, grid_size=8))
    app = App(cfg, device=device)
    if on_cpu:
        app.params = app.params._replace(
            max_height=torch.tensor(12.0, device=app.device))
    ws = float(cfg.terrain.world_size)

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=app.device)

    start = Camera(eye=t([0.0, 0.0, ws * 0.25]), target=t([0.0, 0.0, 0.0]),
                   up=t([0.0, 1.0, 0.0]))
    fpc = FirstPersonController(
        camera=start, heightmap=app.heightmap, world_size=ws,
        max_height=float(app.params.max_height), walk=True,
        move_speed=max(4.0, ws * 0.02))
    fpc.key_event("w", True)                  # hold forward
    dt = 1.0 / 30.0
    for i in range(n):
        if i == n // 2:
            fpc.key_event("shift", True)      # sprint the second half
        fpc.mouse_move(6.0, -1.0)             # gentle look drift
        cam = fpc.animate(dt, app.device)
        app.profiler.begin_frame()
        with app.profiler.scope("Render"):
            out = app.renderer.render(cam, app.params)
            ldr = out.ldr.cpu().numpy()
        app.profiler.end_frame()
        write_png(f"{outdir}/walk_{i:04d}.png", ldr)
        e = fpc.pos
        print(f"frame {i}: eye ({e[0]:7.1f}, {e[1]:6.1f}, {e[2]:7.1f}) "
              f"speed {np.linalg.norm(fpc.vel):5.1f} m/s coverage "
              f"{float((out.prim_id >= 0).float().mean()):.2f}")
    print(app.window_title())
    return app


def main() -> None:
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    outdir = args[0] if args else os.path.join(tempfile.gettempdir(),
                                               "vrt_walk")
    n = int(args[1]) if len(args) > 1 else 8
    walk(outdir, n, device="cpu" if "--cpu" in sys.argv[1:] else None)


if __name__ == "__main__":
    main()
