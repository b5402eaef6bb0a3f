"""Hello triangle: one coloured triangle through the port's rasterizer,
``raster_cuda.rasterize`` (kernel B1 on the card, its plain version on the
CPU), written to a PNG; the analog of the reference's Donut sample shader
(shaders.hlsl:23-52).

    python -m vrenderer_tpu_torch.examples.hello_triangle [out.png] [--cpu]
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

from vrenderer_tpu_torch.app import write_png
from vrenderer_tpu_torch.ops import raster, raster_cuda


def render_triangle(width: int = 512, height: int = 256, device=None):
    """The triangle's frame on ``device`` (the CUDA device unless another
    is given): (rgb (H, W, 3) with a dark background, prim id (H, W))."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("hello_triangle runs on the CUDA device by "
                               "default and none is available; pass "
                               "device=\"cpu\" (or --cpu)")
        device = "cuda"
    dev = torch.device(device)
    # ndc vertices (world_to_clip is the identity) with per-vertex colours
    # in the first attribute channels
    tri = torch.tensor([[-0.7, -0.7, 0.5], [0.0, 0.8, 0.5],
                        [0.7, -0.7, 0.5]], device=dev)
    colors = torch.eye(3, device=dev)
    for order in ([0, 1, 2], [0, 2, 1]):
        attrs = torch.zeros((1, 3, raster_cuda.NUM_ATTRS), device=dev)
        attrs[0, :, 0:3] = colors[order]
        setup = raster.setup_triangles(
            tri[order][None], attrs, torch.ones(1, dtype=torch.bool,
                                                device=dev),
            torch.tensor([[0, 1, 2]], device=dev),
            torch.eye(4, device=dev), width, height)
        if bool(setup.valid[0]):      # the front-facing winding
            break
    packed = raster_cuda.pack_setup(setup, 1)
    work = raster_cuda.full_work_list(1, width, height, device=dev)
    _, prim, at = raster_cuda.rasterize(packed, work, width, height)
    rgb = torch.where((prim >= 0)[..., None], at[..., 0:3],
                      torch.full_like(at[..., 0:3], 0.08))
    return rgb, prim


def main() -> None:
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    out = args[0] if args else os.path.join(tempfile.gettempdir(),
                                            "hello_triangle.png")
    rgb, prim = render_triangle(
        device="cpu" if "--cpu" in sys.argv[1:] else None)
    write_png(out, rgb.cpu().numpy())
    print(f"wrote {out}; covered {float((prim >= 0).float().mean()):.1%} "
          f"on {rgb.device}")


if __name__ == "__main__":
    main()
