"""Render flythrough frames through the port's App on the card; dump PNGs,
a chrome trace and per-frame stats.

Usage: python -m vrenderer_tpu_torch.capture [outdir] [num_frames] [width]
[height] [--scene]
"""

from __future__ import annotations

import math
import os
import sys

import torch

from vrenderer_tpu_torch.app import App
from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings


def _cube_scene(heightmap: torch.Tensor, max_height: float = 400.0,
                world_size: float = 2048.0):
    """A ring of six large cubes resting on the terrain near the
    flythrough's look-at region: the scene path and the shadow interplay
    (cast and receive) end to end."""
    from vrenderer_tpu_torch.models import mesh as meshmod
    from vrenderer_tpu_torch.models import scene as scenemod
    from vrenderer_tpu_torch.ops import texture
    from vrenderer_tpu_torch.utils import math3d

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=heightmap.device)

    insts = []
    for i in range(6):
        ang = i / 6.0 * 2.0 * math.pi
        x, z = 150.0 * math.cos(ang), 150.0 * math.sin(ang)
        ground = float(texture.sample_points(
            heightmap, f32((x + world_size / 2) / world_size),
            f32((z + world_size / 2) / world_size))) * max_height
        size = 25.0 + 10.0 * (i % 3)
        insts.append(scenemod.MeshInstance(
            mesh=meshmod.cube(size, color=(0.8, 0.15 + 0.1 * i, 0.1),
                              device=heightmap.device),
            transform=math3d.affine_translation(
                f32([x, ground + size / 2, z]))))
    return scenemod.Scene(instances=insts)


def main() -> None:
    argv = sys.argv[1:]
    with_scene = "--scene" in argv
    args = [a for a in argv if a != "--scene"]
    outdir = args[0] if len(args) > 0 else "/tmp/vrt_frames"
    n = int(args[1]) if len(args) > 1 else 4
    w = int(args[2]) if len(args) > 2 else 1920
    h = int(args[3]) if len(args) > 3 else 1152
    os.makedirs(outdir, exist_ok=True)

    cfg = FrameConfig(width=w, height=h,
                      terrain=TerrainSettings(max_instances=1024))
    scene = None
    if with_scene:
        from vrenderer_tpu_torch.terrain import heightmap as hmod

        scene = _cube_scene(hmod.procedural_heightmap(256, 1234))
    app = App(cfg, scene=scene)
    outs = app.run_flythrough(num_frames=n, dump_dir=outdir,
                              trace_path=os.path.join(outdir, "trace.json"))
    for i, o in enumerate(outs):
        cov = float((o.prim_id >= 0).float().mean())
        ldr = o.ldr
        print(f"frame {i}: coverage={cov:.3f} "
              f"instances={int(o.num_instances)} mean={float(ldr.mean()):.3f}"
              f" [{float(ldr.min()):.3f},{float(ldr.max()):.3f}]")
    print(f"avg frame (host wall, incl. transfers): "
          f"{app.profiler.average_frame_ms():.1f} ms")
    print(f"wrote {n} frames to {outdir}")


if __name__ == "__main__":
    main()
