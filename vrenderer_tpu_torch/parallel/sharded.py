"""Frames rendered in screen bands over a grid of devices: the PyTorch
counterpart of ``vrenderer_tpu.parallel.sharded``.

The grid (``make_mesh``) has two axes:

* ``frame``: the batch of cameras splits into contiguous chunks, one a
  row of the grid, and each row chains its own chunk;
* ``tile``: each device of a row renders one horizontal band of every
  frame of the chunk, rows [y0, y0 + band_h) with y0 = tile index *
  band_h.

Each band runs the renderer's one frame path (``Renderer._gbuffer`` and
``Renderer._finish_frame``, the two halves of ``_frame_impl``) with
``band=(y0, band_h)``. Geometry (selection, vertex stage, triangle setup)
and the shadow phase are computed whole on every band's device, as in the
JAX package; the setup is then rebased to the band (every plane
E(x, y) = a x + b y + c becomes a x + b y' + (c + b y0)), and the raster
and image-space passes cover the band alone. Eye adaptation, whose target
is a whole-frame statistic, adapts to the sum of the bands' partial
``luminance_sums``, added in band order on the row's first device, where
the JAX package sums over the mesh axis (``psum``).

One process drives every device from one thread. The frame's host
synchronisations (on a CUDA device the work list's ``nonzero``; the
selection syncs nothing there, only on the CPU) run once a band, so
bands on several cards overlap only between them.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import torch

from vrenderer_tpu_torch.camera import Camera
from vrenderer_tpu_torch.ops import lighting
from vrenderer_tpu_torch.renderer import FrameParams, Renderer


class Mesh(NamedTuple):
    """A (frame, tile) grid of devices, ``devices[f][t]``; a device may
    appear more than once."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"frame": len(self.devices), "tile": len(self.devices[0])}


def _canonical(device) -> torch.device:
    """``device`` with the current CUDA index filled in where it has
    none, so that "cuda" and "cuda:0" compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None, n_devices: Optional[int] = None,
              frame_axis: int = 1) -> Mesh:
    """A (frame_axis, n // frame_axis) grid over the first ``n_devices``
    of ``devices`` (default: every CUDA device; a RuntimeError without
    one). Devices may repeat: ``[torch.device("cpu")] * 8`` or
    ``["cuda:0"] * 6`` give one device several bands, the counterpart of
    the JAX tests' virtual CPU devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh takes the CUDA devices by default and none is "
                "available; pass devices=, e.g. [torch.device(\"cpu\")] * 8")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_canonical(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0 or frame_axis < 1 or n % frame_axis:
        raise ValueError(f"frame_axis {frame_axis} does not divide the "
                         f"{n} devices")
    t = n // frame_axis
    return Mesh(tuple(tuple(devs[f * t:(f + 1) * t])
                      for f in range(frame_axis)))


def band_height(renderer: Renderer, mesh: Mesh) -> int:
    """The rows of one band: the frame's height over the tile axis, which
    must split it into whole supertile rows."""
    cfg = renderer.config
    n_tile = mesh.shape["tile"]
    if cfg.height % (cfg.raster.tile_h * n_tile):
        raise ValueError(
            f"height must split into whole supertile rows per device: "
            f"{cfg.height} rows over {n_tile} bands of {cfg.raster.tile_h}-"
            f"row supertiles")
    return cfg.height // n_tile


def _replica(renderer: Renderer, device: torch.device) -> Renderer:
    """The renderer with its state (heightmap, albedo, normal field, scene
    arrays, triangle indices) on ``device``: the renderer itself on its own
    device, else a copy built at the first call and kept until
    ``reload_pipelines`` (the counterpart of the JAX package's cached
    executable, which closes over the same state)."""
    if device == _canonical(renderer.device):
        return renderer
    rep = renderer._band_replicas.get(device)
    if rep is None:
        rep = copy.copy(renderer)
        for name, value in vars(renderer).items():
            if isinstance(value, torch.Tensor):
                setattr(rep, name, value.to(device))
        rep.device = device
        rep._horizon_prepass_cache = None
        rep._shadow_prepass_cache = None
        rep._band_replicas = {}
        renderer._band_replicas[device] = rep
    return rep


def render_frames_sharded(renderer: Renderer, cameras: Camera,
                          params: FrameParams, mesh: Mesh,
                          adapted_lum=None, dt: Optional[float] = None,
                          return_aux: bool = False):
    """Render a batch of frames over a (frame, tile) mesh.

    ``cameras``: fields with a leading (B,) axis, B a multiple of the frame
    axis. Returns the LDR frames (B, H, W, 3), stitched on the mesh's first
    device (the JAX package returns one array sharded over the mesh, which
    torch has no counterpart of).

    ``adapted_lum`` and ``dt``: eye adaptation. Each row of the mesh chains
    the adapted luminance through its own chunk of the batch from
    ``adapted_lum`` (with one row, the sequential ``render_adaptive``
    chain), each frame adapting to the sum of its bands' statistics.

    ``return_aux``: also return ``overflow`` (B, n_tile) bool, each band's
    flag (their OR is the frame's), and ``adapted`` (B, n_tile) float32,
    the luminance after each frame, equal across a frame's bands (0.5
    without adaptation, as in the JAX package).

    The scene transforms travel with the call; the rest of the renderer's
    state reaches another device once (``_replica``). No shadow prepass
    is used: each band runs its frame's shadow phase.
    """
    adapting = adapted_lum is not None
    band_h = band_height(renderer, mesh)
    n_frame, n_tile = mesh.shape["frame"], mesh.shape["tile"]
    B = cameras.eye.shape[0]
    if B % n_frame:
        raise ValueError(f"{B} cameras do not split over {n_frame} rows of "
                         f"the mesh")
    chunk = B // n_frame
    first = mesh.devices[0][0]
    cfg = renderer.config
    scene_xf = (renderer.scene_transforms
                if renderer._scene_obj is not None else None)

    def on(dev):
        return (_replica(renderer, dev),
                FrameParams(*(p.to(dev) for p in params)),
                None if scene_xf is None else scene_xf.to(dev))

    rows = [[(dev, t * band_h) + on(dev) for t, dev in enumerate(row)]
            for row in mesh.devices]
    frames = torch.empty((B, cfg.height, cfg.width, 3), dtype=torch.float32,
                         device=first)
    overflow = torch.empty((B, n_tile), dtype=torch.bool, device=first)
    adapted = torch.empty((B, n_tile), dtype=torch.float32, device=first)
    lums = [torch.as_tensor(adapted_lum if adapting else 0.5,
                            dtype=torch.float32, device=row[0])
            for row in mesh.devices]
    with torch.no_grad():
        for k in range(chunk):
            for f, row in enumerate(rows):
                i = f * chunk + k
                gbs = []
                for dev, y0, rep, p, xf in row:
                    cam = Camera(*(v[i].to(dev) for v in cameras))
                    gbs.append(rep._gbuffer(cam, p, band=(y0, band_h),
                                            scene_xf=xf))
                scale = None
                if adapting:
                    sums = [lighting.luminance_sums(g.hdr, g.covered)
                            .to(row[0][0]) for g in gbs]
                    lums[f], scale = lighting.adapt_from_sums(
                        sum(sums[1:], sums[0]), lums[f], float(dt))
                for t, ((dev, y0, rep, p, _), g) in enumerate(zip(row, gbs)):
                    exposure = (p.exposure if scale is None
                                else p.exposure * scale.to(dev))
                    out = rep._finish_frame(g, p, exposure)
                    frames[i, y0:y0 + band_h] = out.ldr.to(first)
                    overflow[i, t] = out.overflow.to(first)
                    adapted[i, t] = lums[f].to(first)
    if return_aux:
        return frames, overflow, adapted
    return frames
