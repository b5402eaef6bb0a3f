"""The port's compile-and-run entry, the counterpart of the JAX package's
``__graft_entry__.entry``: one whole frame (CDLOD selection, vertex
stage, kernel B1, deferred lighting, tonemap, sky) at 1080p on the card.

    python -m vrenderer_tpu_torch.entry
"""

from __future__ import annotations

import torch


def entry(device=None):
    """(fn, args): ``fn(eye, target)`` renders one frame and returns its
    ldr (H, W, 3). On the CUDA device (the default) the frame is 1920x1152
    over the 2048 m world (max_instances 1024, grid 32, max_work 2048); on
    another device, ``device="cpu"`` for tests, the small configuration of
    the JAX entry's CPU branch (256x128, 64 m world, max_instances 64,
    grid 8, max_work 256)."""
    from vrenderer_tpu_torch.camera import Camera
    from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings
    from vrenderer_tpu_torch.renderer import FrameParams, Renderer
    from vrenderer_tpu_torch.terrain import heightmap as hmod

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("entry renders on the CUDA device by default "
                               "and none is available; pass device=\"cpu\"")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        width, height, surface, cap, grid, max_work = (1920, 1152, 2048,
                                                       1024, 32, 2048)
    else:
        width, height, surface, cap, grid, max_work = 256, 128, 64, 64, 8, 256
    cfg = FrameConfig(width=width, height=height, terrain=TerrainSettings(
        surface_size=surface, world_size=surface, max_instances=cap,
        grid_size=grid))
    hm = hmod.procedural_heightmap(min(256, surface), device=dev)
    renderer = Renderer(cfg, hm, hmod.procedural_albedo(hm),
                        max_work=max_work, device=dev)
    params = FrameParams.default(device=dev)
    up = torch.tensor([0.0, 1.0, 0.0], device=dev)

    def fn(eye, target):
        return renderer.render(Camera(eye=eye, target=target, up=up),
                               params).ldr

    cam0 = Camera.default(dev)
    return fn, (cam0.eye, cam0.target)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"entry ok: {tuple(out.shape)} {out.dtype} on "
          f"{torch.cuda.get_device_name(0)}, finite "
          f"{bool(torch.isfinite(out).all())}")
