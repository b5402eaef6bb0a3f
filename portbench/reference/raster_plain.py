"""The binned rasterizer's plain PyTorch form: the work list of
(instance, supertile) pairs, then every (triangle, pixel) pair of each
triangle's bbox within its item's supertile, expanded in chunks and merged
with ``scatter_reduce("amin")`` on int64 keys ``(z bits << 32) | gid``, so
the nearest covered triangle wins and ties go to the lowest global id
``inst * T + t``; the depth-only form merges z alone. Order-free, so exact
on any device.

A frozen copy of ``vrenderer_tpu_torch.ops.raster_cuda``'s plain versions
(``build_work_list``, ``rasterize_plain``, ``rasterize_depth_plain`` and
what they call) as they stood when the benchmark was written, without the
kernels and their wrappers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.raster import F32_FAR, TriSetup

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


class PairRects(NamedTuple):
    """(triangle, pixel) pairs as pixel rectangles, each of one triangle
    (e.g. its bbox ∩ a work item's supertile): top-left (x0, y0), width
    ``wd``, pixel count ``cnt``, global id ``gid`` and the 12 plane
    coefficients ``planes``."""

    x0: torch.Tensor
    y0: torch.Tensor
    wd: torch.Tensor
    cnt: torch.Tensor
    gid: torch.Tensor
    planes: torch.Tensor


def _window_hits(vis: torch.Tensor, inst: torch.Tensor, x0w, y0w, x1w,
                 y1w):
    """(window index, rect) of each triangle of instance ``inst[k]`` whose
    bbox meets window k, [x0w, x1w] x [y0w, y1w] ((n, 1) float32,
    inclusive, inside the frame); the rect is bbox ∩ window, and may hold
    no pixel (``wd`` or its height <= 0)."""
    T = vis.shape[1]
    bb = vis[inst, :, 12:16]                                   # (n, T, 4)
    hit = ((bb[..., 0] <= x1w) & (bb[..., 2] >= x0w)
           & (bb[..., 1] <= y1w) & (bb[..., 3] >= y0w))
    w_i, t_i = hit.nonzero(as_tuple=True)
    rect = bb[w_i, t_i]
    x0 = torch.maximum(torch.ceil(rect[:, 0]), x0w[w_i, 0]).long()
    y0 = torch.maximum(torch.ceil(rect[:, 1]), y0w[w_i, 0]).long()
    wd = torch.minimum(torch.floor(rect[:, 2]), x1w[w_i, 0]).long() - x0 + 1
    ht = torch.minimum(torch.floor(rect[:, 3]), y1w[w_i, 0]).long() - y0 + 1
    return w_i, PairRects(x0=x0, y0=y0, wd=wd, cnt=wd * ht,
                          gid=inst[w_i] * T + t_i,
                          planes=vis[inst[w_i], t_i, :12])


def _window_rects(vis: torch.Tensor, inst: torch.Tensor, x0w, y0w, x1w,
                  y1w) -> PairRects:
    """The rects (bbox ∩ window) of the triangles of instance ``inst[k]``
    whose bbox meets window k (``_window_hits``)."""
    return _window_hits(vis, inst, x0w, y0w, x1w, y1w)[1]


def pair_rects(vis: torch.Tensor, work: WorkList, width: int, height: int,
               tile: int = TILE) -> PairRects:
    """The (triangle, pixel) pairs of every triangle's bbox ∩ supertile for
    ``work``: the pairs the plain versions evaluate; ``cnt.sum()`` is the
    bbox pair count."""
    tiles_x, _ = _tiles(width, height, tile)
    items = work.items[work.items[:, 0] >= 0].long()
    inst, st = items[:, 0], items[:, 1]
    tx0 = ((st % tiles_x) * tile).to(torch.float32)[:, None]
    ty0 = ((st // tiles_x) * tile).to(torch.float32)[:, None]
    tx1 = torch.clamp(tx0 + tile, max=width) - 1
    ty1 = torch.clamp(ty0 + tile, max=height) - 1
    return _window_rects(vis, inst, tx0, ty0, tx1, ty1)


def _covered_pairs(vis: torch.Tensor, work: WorkList, width: int,
                   height: int, tile: int, chunk: int, wire_px: float = 0.0,
                   rects: PairRects | None = None):
    """The kernels' coverage, expanded in plain PyTorch: yields, ``chunk``
    (triangle, pixel) pairs at a time, the covered pairs' (pixel index, z
    with -0.0 made +0.0, global id) over ``rects`` (default
    ``pair_rects``)."""
    dev = vis.device
    if rects is None:
        rects = pair_rects(vis, work, width, height, tile)
    x0, y0, wd, cnt, gid, pc = rects
    start = torch.cumsum(cnt, 0) - cnt
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

        e0, e1, e2, zq = plane(0), plane(3), plane(6), plane(9)
        cover = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
                 & (zq >= 0.0) & (zq <= 1.01))
        if wire_px > 0.0:
            cover &= torch.minimum(e0, torch.minimum(e1, e2)) <= wire_px
        # +0.0 canonicalises -0.0, whose bits would sort above every z
        yield (y * width + x)[cover], zq[cover] + 0.0, gid[r][cover]


def _merge_keys_plain(vis, work, width, height, tile, reverse_z, wire_px,
                      chunk):
    """Per-pixel int64 keys ``(z_key << 32) | gid`` merged with ``amin``:
    z_key is the z bits, or their 31-bit complement under reverse-z (the
    kernel's ~bits, kept positive for the signed merge); untouched pixels
    hold _KEY_EMPTY."""
    keys = torch.full((height * width,), _KEY_EMPTY, dtype=torch.int64,
                      device=vis.device)
    for pix, zq, gid in _covered_pairs(vis, work, width, height, tile, chunk,
                                       wire_px):
        zkey = zq.view(torch.int32).to(torch.int64)
        if reverse_z:
            zkey = zkey ^ 0x7FFFFFFF
        keys.scatter_reduce_(0, pix, (zkey << 32) | gid, "amin")
    return keys


def _decode_plain(keys: torch.Tensor, width: int, height: int,
                  reverse_z: bool):
    """Keys -> (z (H, W), id (H, W)), with the background convention."""
    bg = keys == _KEY_EMPTY
    zkey = keys >> 32
    if reverse_z:
        zkey = zkey ^ 0x7FFFFFFF
    zb = zkey.to(torch.int32).view(torch.float32)
    z = torch.where(bg, torch.full_like(zb, -F32_FAR if reverse_z
                                        else F32_FAR), zb)
    ids = torch.where(bg, torch.full_like(keys, -1), keys & 0xFFFFFFFF)
    return (z.reshape(height, width),
            ids.to(torch.int32).reshape(height, width))


def _attrs_plain(coef: torch.Tensor, ids: torch.Tensor, write: torch.Tensor):
    """The winners' perspective-divided attributes (H, W, 8) where
    ``write`` is set, 0 elsewhere."""
    height, width = ids.shape
    dev = ids.device
    gid = torch.where(write, ids, torch.zeros_like(ids)).reshape(-1).long()
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
    attrs = torch.where(write.reshape(-1, 1), attrs, torch.zeros_like(attrs))
    return attrs.reshape(height, width, NUM_ATTRS)


def rasterize_plain(packed: PackedTris, work: WorkList, width: int,
                    height: int, tile: int = TILE, reverse_z: bool = False,
                    wire_px: float = 0.0, chunk: int = 1 << 21):
    """Plain PyTorch version of kernel B1: same inputs, outputs and key
    semantics. ``chunk`` bounds the (triangle, pixel) pairs evaluated at
    once."""
    keys = _merge_keys_plain(packed.vis, work, width, height, tile,
                             reverse_z, wire_px, chunk)
    z, ids = _decode_plain(keys, width, height, reverse_z)
    return z, ids, _attrs_plain(packed.coef, ids, ids >= 0)


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
