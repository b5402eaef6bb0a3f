"""The port's compile-and-run entries, the counterparts of the JAX
package's ``__graft_entry__``: ``entry``, one whole frame (CDLOD
selection, vertex stage, kernel B1, deferred lighting, tonemap, sky) at
1080p on the card, and ``dryrun_multichip``, one step of the sharded
screen-band path.

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


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of the sharded path over a mesh of ``n_devices`` entries:
    frame-batch parallelism (2 rows when ``n_devices`` is even) times
    screen bands, at 256 x (128 x bands) over the 64 m world (max_instances
    64, grid 8, max_work 256), the JAX dry run's configuration. The entries
    repeat the CUDA devices (the default; a RuntimeError without one), or
    ``device`` (``"cpu"`` for tests), when fewer exist. Raises unless the
    frames have the expected shape and are finite."""
    from vrenderer_tpu_torch.camera import Camera
    from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings
    from vrenderer_tpu_torch.parallel import sharded
    from vrenderer_tpu_torch.renderer import FrameParams, Renderer
    from vrenderer_tpu_torch.terrain import heightmap as hmod

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip runs on the CUDA devices by "
                               "default and none is available; pass "
                               "device=\"cpu\"")
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        avail = [torch.device(device)]
    devices = [avail[i % len(avail)] for i in range(n_devices)]
    frame_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    height = 128 * (n_devices // frame_axis)
    dev = devices[0]
    cfg = FrameConfig(width=256, height=height, terrain=TerrainSettings(
        surface_size=64, world_size=64, max_instances=64, grid_size=8))
    hm = hmod.procedural_heightmap(64, device=dev)
    renderer = Renderer(cfg, hm, hmod.procedural_albedo(hm), max_work=256,
                        device=dev)
    mesh = sharded.make_mesh(devices, frame_axis=frame_axis)

    t = torch.linspace(0.0, 1.0, frame_axis, device=dev)
    cams = Camera(
        eye=torch.stack([t * 5.0, 25.0 + 0 * t, 45.0 - t], dim=-1),
        target=torch.zeros((frame_axis, 3), device=dev),
        up=torch.tensor([[0.0, 1.0, 0.0]], device=dev).repeat(frame_axis, 1))
    params = FrameParams.default(device=dev)._replace(
        max_height=torch.tensor(12.0, device=dev))
    frames = sharded.render_frames_sharded(renderer, cams, params, mesh)
    if tuple(frames.shape) != (frame_axis, height, 256, 3):
        raise RuntimeError(f"dry run frames {tuple(frames.shape)}")
    if not bool(torch.isfinite(frames).all()):
        raise RuntimeError("dry run frames are not finite")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"entry ok: {tuple(out.shape)} {out.dtype} on "
          f"{torch.cuda.get_device_name(0)}, finite "
          f"{bool(torch.isfinite(out).all())}")
