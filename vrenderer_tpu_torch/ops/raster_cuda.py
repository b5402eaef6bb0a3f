"""Binned rasterizer: the counterpart of ``vrenderer_tpu.ops.raster_pallas``.

The frame's triangles are ``I`` instances of ``T`` triangles (terrain
patches, then scene-mesh blocks). The screen is cut into 128x128
supertiles, each instance is binned to the supertiles its screen bbox
meets, and ``rasterize`` resolves every pixel to the minimum-z covering
triangle (ties to the lowest global id ``inst * T + t``) and its
perspective-correct attributes.

* ``rasterize`` is the wrapper. A CUDA tensor launches the hand-written
  kernel in ``csrc/raster.cu`` (built by ``_build``), which replaces the
  Pallas kernel ``raster_pallas._raster_kernel`` (full variant, via
  ``rasterize_pallas``); ``rasterize.launches`` counts those launches. A
  CPU tensor runs ``rasterize_plain``.
* ``rasterize_plain`` is the plain PyTorch version with the same semantics:
  (triangle, pixel) pairs of each work item are expanded in chunks and
  merged with ``scatter_reduce("amin")`` on int64 keys
  ``(z_bits << 32) | gid``. It is the CPU path and the card's reference.
* ``rasterize_depth`` is the depth-only wrapper for the map-mode light
  view: it reads only the 16 visibility floats per triangle
  (``pack_vis``) and returns the minimum covered z, bit-identical to
  ``rasterize``'s z. A CUDA tensor launches kernel B2 (``vrt_raster_depth``
  in ``csrc/raster.cu``), which replaces ``raster_pallas._raster_kernel``
  (depth-only variant, via ``rasterize_pallas_depth``);
  ``rasterize_depth.launches`` counts those launches. A CPU tensor runs
  ``rasterize_depth_plain``, the same pair expansion merged with
  ``scatter_reduce("amin")`` on z.

The work list keeps the JAX package's count (one leading dummy per
supertile plus every overlapping (usable instance, supertile) pair, so
``FrameOutput.num_work_items`` agrees) and drops the same items on
overflow: the first ``max_work`` in supertile-major, near-to-far order
survive. Near-to-far order and item-level early-z are only speed-ups on
the TPU; the kernel here needs neither.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vrenderer_tpu_torch.ops.raster import F32_FAR, TriSetup

NUM_ATTRS = 8
NUM_COEF = 3 * (1 + NUM_ATTRS)    # [inv_w, attr0..7] x (a, b, c)
VIS_STRIDE = 16                   # 3 edges x 3, z plane x 3, bbox x 4
TILE = 128
_KEY_EMPTY = torch.iinfo(torch.int64).max


class PackedTris(NamedTuple):
    """Per-triangle kernel inputs, triangle-major.

    vis:  (I, T, 16) float32, rows e0(a, b, c) e1 e2 z(a, b, c) and the
          inclusive pixel bbox (x0, y0, x1, y1); invalid triangles have
          zero planes and the empty bbox (+FAR, +FAR, -FAR, -FAR).
    coef: (I, T, 27) float32, (a, b, c) of inv_w then attr_k / w.
    """

    vis: torch.Tensor
    coef: torch.Tensor


class WorkList(NamedTuple):
    """items: (max_work, 2) int32 (instance, supertile) pairs in
    supertile-major order, (-1, -1) in unused slots. num_items: () int64,
    the JAX package's work-item count (overflow when > max_work)."""

    items: torch.Tensor
    num_items: torch.Tensor


def pack_vis(setup: TriSetup, num_instances: int) -> torch.Tensor:
    """The visibility rows (I, T, 16) of a TriSetup over I*T triangles
    (planes [z, ...]): all the depth-only raster reads."""
    N = setup.edge.shape[0]
    ok = setup.valid[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    planes = torch.cat([setup.edge.reshape(N, 9), setup.planes[:, 0, :]], 1)
    empty = torch.tensor([F32_FAR, F32_FAR, -F32_FAR, -F32_FAR],
                         dtype=torch.float32, device=ok.device)
    vis = torch.cat([torch.where(ok, planes, zero),
                     torch.where(ok, setup.bbox, empty)], 1)
    return vis.reshape(num_instances, N // num_instances,
                       VIS_STRIDE).contiguous()


def pack_setup(setup: TriSetup, num_instances: int) -> PackedTris:
    """TriSetup over I*T triangles (planes [z, inv_w, 8 attr/w]) ->
    PackedTris."""
    N = setup.edge.shape[0]
    if setup.planes.shape[1] != 2 + NUM_ATTRS:
        raise ValueError(f"expected z, inv_w and {NUM_ATTRS} attribute "
                         f"planes, got {setup.planes.shape[1]}")
    zero = torch.zeros((), dtype=torch.float32, device=setup.valid.device)
    coef = torch.where(setup.valid[:, None],
                       setup.planes[:, 1:, :].reshape(N, NUM_COEF), zero)
    return PackedTris(vis=pack_vis(setup, num_instances),
                      coef=coef.reshape(num_instances, N // num_instances,
                                        NUM_COEF).contiguous())


def instance_bbox_components(comp, width: int, height: int,
                             inst_valid: torch.Tensor, w_eps: float = 1e-4):
    """Conservative per-instance pixel bbox from the per-vertex clip
    coordinates: the in-front vertex hull with 1 px padding, widened to the
    full frame when the instance straddles the near plane. Returns
    (bbox (I, 4), usable (I,), dist (I,)); dist (nearest in-front clip w)
    orders the work list."""
    cx, cy, _, cw = comp.vert_clip
    front = cw > w_eps
    big = 1e9
    inv_w = 1.0 / torch.where(front, cw, torch.ones_like(cw))
    sx = (cx * inv_w * 0.5 + 0.5) * width
    sy = (0.5 - cy * inv_w * 0.5) * height

    def ext(v, fill, op):
        return op(torch.where(front, v, torch.full_like(v, fill)), dim=1)

    x0 = ext(sx, big, torch.amin) - 1.0
    y0 = ext(sy, big, torch.amin) - 1.0
    x1 = ext(sx, -big, torch.amax) + 1.0
    y1 = ext(sy, -big, torch.amax) + 1.0
    any_front = front.any(dim=1)
    crossing = any_front & (~front).any(dim=1)
    zero = torch.zeros_like(x0)
    x0 = torch.where(crossing, zero, x0)
    y0 = torch.where(crossing, zero, y0)
    x1 = torch.where(crossing, zero + (width - 1.0), x1)
    y1 = torch.where(crossing, zero + (height - 1.0), y1)
    on = (x1 >= 0) & (y1 >= 0) & (x0 < width) & (y0 < height)
    dist = ext(cw, big, torch.amin)
    return (torch.stack([x0, y0, x1, y1], dim=-1), inst_valid & on & any_front,
            dist)


def _tiles(width: int, height: int, tile: int):
    tiles_x = -(-width // tile)
    return tiles_x, tiles_x * -(-height // tile)


def build_work_list(bbox: torch.Tensor, usable: torch.Tensor, width: int,
                    height: int, tile: int = TILE, max_work: int = 2048,
                    order_key: torch.Tensor | None = None) -> WorkList:
    """(instance, supertile) pairs whose bboxes overlap, supertile-major,
    near-to-far (stable sort of ``order_key``) within a supertile, behind
    one dummy slot per supertile that counts but is never stored. Items at
    counted positions >= max_work are dropped, as in the JAX package."""
    dev = bbox.device
    tiles_x, n_st = _tiles(width, height, tile)
    I = bbox.shape[0]
    if order_key is not None:
        key = torch.where(usable, order_key,
                          torch.full_like(order_key, float("inf")))
        perm = torch.argsort(key, stable=True)
    else:
        perm = torch.arange(I, device=dev)
    bbox = bbox[perm]
    usable = usable[perm]

    st = torch.arange(n_st, device=dev)
    tx = ((st % tiles_x) * tile).to(torch.float32)[:, None]
    ty = ((st // tiles_x) * tile).to(torch.float32)[:, None]
    ovl = ((bbox[:, 0][None, :] <= tx + (tile - 1))
           & (bbox[:, 2][None, :] >= tx)
           & (bbox[:, 1][None, :] <= ty + (tile - 1))
           & (bbox[:, 3][None, :] >= ty)
           & usable[None, :])                              # (n_st, I)
    full = torch.cat([torch.ones((n_st, 1), dtype=torch.bool, device=dev),
                      ovl], dim=1)
    pos = torch.cumsum(full.reshape(-1), 0).reshape(n_st, I + 1) - 1
    num_items = full.sum()
    kept = (ovl & (pos[:, 1:] < max_work)).nonzero()       # row-major order
    items = torch.full((max_work, 2), -1, dtype=torch.int32, device=dev)
    n = kept.shape[0]
    items[:n, 0] = perm[kept[:, 1]].to(torch.int32)
    items[:n, 1] = kept[:, 0].to(torch.int32)
    return WorkList(items=items, num_items=num_items)


def full_work_list(num_instances: int, width: int, height: int,
                   tile: int = TILE, device=None) -> WorkList:
    """Every (instance, supertile) pair: the work list of a small target
    whose instances may cover it anywhere (mesh_top_field)."""
    _, n_st = _tiles(width, height, tile)
    inst, st = torch.meshgrid(torch.arange(num_instances, device=device),
                              torch.arange(n_st, device=device),
                              indexing="ij")
    items = torch.stack([inst.reshape(-1), st.reshape(-1)], 1)
    return WorkList(items=items.to(torch.int32).contiguous(),
                    num_items=torch.tensor(items.shape[0], device=device))


def _check(vis: torch.Tensor, coef: torch.Tensor | None, work: WorkList):
    """Device, shape, dtype and contiguity of the kernels' inputs."""
    device = vis.device
    I, T = vis.shape[0], vis.shape[1]
    expect = [(vis, (I, T, VIS_STRIDE), torch.float32),
              (work.items, (work.items.shape[0], 2), torch.int32)]
    if coef is not None:
        expect.append((coef, (I, T, NUM_COEF), torch.float32))
    for x, shape, dtype in expect:
        if x.device != device:
            raise ValueError(f"raster inputs on {x.device} and {device}")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"raster input {tuple(x.shape)} {x.dtype}, "
                             f"expected {shape} {dtype}")
        if not x.is_contiguous():
            raise ValueError("raster inputs must be contiguous")


def _launch(entry: str, device: torch.device, *args) -> None:
    """Call the library's ``entry`` with ``args`` and the current stream of
    ``device``; raise if the launch failed."""
    from vrenderer_tpu_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def rasterize(packed: PackedTris, work: WorkList, width: int, height: int,
              tile: int = TILE, reverse_z: bool = False,
              wire_px: float = 0.0):
    """Returns (z (H, W) float32, F32_FAR background; id (H, W) int32, -1
    background; attrs (H, W, 8) float32, perspective-divided, 0 on the
    background). CUDA tensors launch the kernel, CPU tensors run
    ``rasterize_plain``."""
    if reverse_z or wire_px > 0.0:
        raise NotImplementedError("reverse_z and wireframe are not ported "
                                  "yet (ROADMAP.md, A14)")
    device = packed.vis.device
    _check(packed.vis, packed.coef, work)
    if device.type == "cpu":
        return rasterize_plain(packed, work, width, height, tile)
    if device.type != "cuda":
        raise ValueError(f"no rasterizer for device {device}")
    vis, coef = packed
    z = torch.empty((height, width), dtype=torch.float32, device=device)
    ids = torch.empty((height, width), dtype=torch.int32, device=device)
    attrs = torch.empty((height, width, NUM_ATTRS), dtype=torch.float32,
                        device=device)
    keys = torch.empty((height * width,), dtype=torch.int64, device=device)
    tiles_x, _ = _tiles(width, height, tile)
    _launch("vrt_raster", device, vis.data_ptr(), coef.data_ptr(),
            work.items.data_ptr(), work.items.shape[0], vis.shape[1], tiles_x,
            tile, width, height, keys.data_ptr(), z.data_ptr(),
            ids.data_ptr(), attrs.data_ptr())
    rasterize.launches += 1
    return z, ids, attrs


rasterize.launches = 0


def rasterize_depth(vis: torch.Tensor, work: WorkList, width: int,
                    height: int, tile: int = TILE) -> torch.Tensor:
    """Depth-only raster of the visibility rows ``vis`` (I, T, 16): z
    (H, W) float32 of the nearest covered triangle, F32_FAR where none
    covers. CUDA tensors launch kernel B2, CPU tensors run
    ``rasterize_depth_plain``."""
    device = vis.device
    _check(vis, None, work)
    if device.type == "cpu":
        return rasterize_depth_plain(vis, work, width, height, tile)
    if device.type != "cuda":
        raise ValueError(f"no rasterizer for device {device}")
    z = torch.empty((height, width), dtype=torch.float32, device=device)
    tiles_x, _ = _tiles(width, height, tile)
    _launch("vrt_raster_depth", device, vis.data_ptr(), work.items.data_ptr(),
            work.items.shape[0], vis.shape[1], tiles_x, tile, width, height,
            z.data_ptr())
    rasterize_depth.launches += 1
    return z


rasterize_depth.launches = 0


def _covered_pairs(vis: torch.Tensor, work: WorkList, width: int,
                   height: int, tile: int, chunk: int):
    """The kernels' coverage, expanded in plain PyTorch: yields, ``chunk``
    (triangle, pixel) pairs at a time, the covered pairs' (pixel index, z
    with -0.0 made +0.0, global id)."""
    dev = vis.device
    T = vis.shape[1]
    tiles_x, _ = _tiles(width, height, tile)
    items = work.items[work.items[:, 0] >= 0].long()
    inst, st = items[:, 0], items[:, 1]
    tx0 = ((st % tiles_x) * tile).to(torch.float32)[:, None]
    ty0 = ((st // tiles_x) * tile).to(torch.float32)[:, None]
    tx1 = torch.clamp(tx0 + tile, max=width) - 1
    ty1 = torch.clamp(ty0 + tile, max=height) - 1

    # (item, triangle) pairs whose bbox meets the item's supertile, and the
    # pixel rectangle bbox ∩ tile of each
    bb = vis[inst, :, 12:16]                                   # (W, T, 4)
    hit = ((bb[..., 0] <= tx1) & (bb[..., 2] >= tx0)
           & (bb[..., 1] <= ty1) & (bb[..., 3] >= ty0))
    w_i, t_i = hit.nonzero(as_tuple=True)
    rect = bb[w_i, t_i]
    x0 = torch.maximum(torch.ceil(rect[:, 0]), tx0[w_i, 0]).long()
    y0 = torch.maximum(torch.ceil(rect[:, 1]), ty0[w_i, 0]).long()
    wd = torch.minimum(torch.floor(rect[:, 2]), tx1[w_i, 0]).long() - x0 + 1
    ht = torch.minimum(torch.floor(rect[:, 3]), ty1[w_i, 0]).long() - y0 + 1
    cnt = wd * ht
    start = torch.cumsum(cnt, 0) - cnt
    gid = inst[w_i] * T + t_i
    pc = vis[inst[w_i], t_i, :12]                              # (n, 12)

    total = int(cnt.sum())
    for lo in range(0, total, chunk):
        p0, p1 = torch.searchsorted(
            start, torch.tensor([lo, lo + chunk], device=dev)).tolist()
        if p0 == p1:
            continue
        c = cnt[p0:p1]
        n = int(c.sum())
        rep = torch.repeat_interleave(
            torch.arange(p1 - p0, device=dev), c, output_size=n)
        local = torch.arange(n, device=dev) - (start[p0:p1] - start[p0])[rep]
        r = rep + p0
        x = x0[r] + local % wd[r]
        y = y0[r] + local // wd[r]
        px = x.to(torch.float32) + 0.5
        py = y.to(torch.float32) + 0.5
        cf = pc[r]

        def plane(j):
            return cf[:, j] * px + cf[:, j + 1] * py + cf[:, j + 2]

        zq = plane(9)
        cover = ((plane(0) >= 0.0) & (plane(3) >= 0.0) & (plane(6) >= 0.0)
                 & (zq >= 0.0) & (zq <= 1.01))
        # +0.0 canonicalises -0.0, whose bits would sort above every z
        yield (y * width + x)[cover], zq[cover] + 0.0, gid[r][cover]


def rasterize_plain(packed: PackedTris, work: WorkList, width: int,
                    height: int, tile: int = TILE, chunk: int = 1 << 21):
    """Plain PyTorch version of kernel B1: same inputs, outputs and key
    semantics. ``chunk`` bounds the (triangle, pixel) pairs evaluated at
    once."""
    keys = torch.full((height * width,), _KEY_EMPTY, dtype=torch.int64,
                      device=packed.vis.device)
    for pix, zq, gid in _covered_pairs(packed.vis, work, width, height, tile,
                                       chunk):
        zbits = zq.view(torch.int32).to(torch.int64)
        keys.scatter_reduce_(0, pix, (zbits << 32) | gid, "amin")
    return _resolve_plain(keys, packed.coef, width, height)


def rasterize_depth_plain(vis: torch.Tensor, work: WorkList, width: int,
                          height: int, tile: int = TILE,
                          chunk: int = 1 << 21) -> torch.Tensor:
    """Plain PyTorch version of kernel B2: the pairs of ``rasterize_plain``
    merged with a float ``amin`` (order-free, so exact on every device)."""
    z = torch.full((height * width,), F32_FAR, dtype=torch.float32,
                   device=vis.device)
    for pix, zq, _ in _covered_pairs(vis, work, width, height, tile, chunk):
        z.scatter_reduce_(0, pix, zq, "amin")
    return z.reshape(height, width)


def _resolve_plain(keys: torch.Tensor, coef: torch.Tensor, width: int,
                   height: int):
    """Decode the per-pixel keys and evaluate the winners' planes."""
    dev = keys.device
    bg = keys == _KEY_EMPTY
    gid = torch.where(bg, torch.zeros_like(keys), keys & 0xFFFFFFFF)
    zb = (keys >> 32).to(torch.int32).view(torch.float32)
    z = torch.where(bg, torch.full_like(zb, F32_FAR), zb)
    ids = torch.where(bg, torch.full_like(gid, -1), gid).to(torch.int32)
    p = torch.arange(height * width, device=dev)
    px = (p % width).to(torch.float32) + 0.5
    py = (p // width).to(torch.float32) + 0.5
    cf = coef.reshape(-1, NUM_COEF)

    def plane(j):
        return cf[gid, j] * px + cf[gid, j + 1] * py + cf[gid, j + 2]

    inv_w = plane(0)
    denom = torch.where(torch.abs(inv_w) > 1e-20, inv_w,
                        torch.ones_like(inv_w))
    attrs = torch.stack([plane(3 * (k + 1)) / denom
                         for k in range(NUM_ATTRS)], dim=-1)
    attrs = torch.where(bg[:, None], torch.zeros_like(attrs), attrs)
    return (z.reshape(height, width), ids.reshape(height, width),
            attrs.reshape(height, width, NUM_ATTRS))
