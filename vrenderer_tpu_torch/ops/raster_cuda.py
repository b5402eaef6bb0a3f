"""Binned rasterizer: the counterpart of ``vrenderer_tpu.ops.raster_pallas``.

The frame's triangles are ``I`` instances of ``T`` triangles (terrain
patches, then scene-mesh blocks). The screen is cut into 128x128
supertiles, each instance is binned to the supertiles its screen bbox
meets, and ``rasterize`` resolves every pixel to the minimum-z covering
triangle (the maximum under ``reverse_z``; ties to the lowest global id
``inst * T + t``) and its perspective-correct attributes. ``wire_px > 0``
is the wireframe fill mode: a pixel covers only within ``wire_px`` of an
edge.

Each wrapper launches a hand-written kernel of ``csrc/raster.cu`` (built
by ``_build``) for CUDA tensors, counting the launches on the wrapper, and
runs its plain PyTorch version, the CPU path and the card's reference, for
CPU tensors. B1, B2 and B3a share one design: a binning pass on the device
lists each triangle in the ``region`` x ``region`` pixel squares of its
work item's supertile that its bbox meets, with its cost (the pixels of
its bbox there, or of the 8x8 blocks an exact-margin test keeps); the
raster launch, a persistent grid of blocks, then takes each region's list
in chunks of about ``CHUNK`` evaluated pairs, so a hot region gets as
many blocks as its pairs need. ``region_bins`` mirrors the binning and
``block_pair_rects`` the block test in PyTorch; ``device_bins`` reads the
card's bins back and ``winner_rows`` runs B1's output gather alone, both
for measuring. The layout keyword ``region`` shapes only the blocks, never
the result:

* ``rasterize``: kernel B1 (``vrt_raster``), replacing the Pallas kernel
  ``raster_pallas._raster_kernel`` (full variant, via
  ``rasterize_pallas``). ``rasterize_plain`` expands the (triangle, pixel)
  pairs of each work item in chunks and merges them with
  ``scatter_reduce("amin")`` on int64 keys ``(z_key << 32) | gid``.
* ``rasterize_depth``: kernel B2 (``vrt_raster_depth``), the map-mode
  light view's depth-only raster, replacing
  ``_raster_kernel(depth_only)`` (via ``rasterize_pallas_depth``). It reads
  only the 16 visibility floats per triangle (``pack_vis``) and returns
  the minimum covered z, bit-identical to ``rasterize``'s z;
  ``rasterize_depth_plain`` merges the same pairs with a float ``amin``.
* Two-phase rasterization (``RasterSettings.two_phase``),
  ``rasterize_two_phase``: ``rasterize_zid``, kernel B3a
  (``vrt_raster_zid``, replacing ``_raster_kernel(depth_only, with_id)``
  via ``rasterize_pallas_zid``), rasters z and the winner id, bit-identical
  to ``rasterize``'s; ``filter_work_to_winners`` (kernel
  ``vrt_filter_winners``, one launch for the JAX package's plain-JAX
  filter) keeps the (work item, cell) pairs whose instance may have won a
  pixel of the cell; ``rasterize_resolve``, kernel B3b
  (``vrt_raster_resolve``, replacing ``_resolve_kernel`` via
  ``rasterize_pallas_resolve``), evaluates the winners' attributes where
  their item is live at the pixel's cell, bit-identical to
  ``rasterize``'s. Both take each pixel once, one block per supertile (the
  filter) or per band of rows of one (B3b).

Before the raster, ``setup_packed`` sets the frame's triangles up into
the packed rows (``PackedTris``) and the instance bounds the work list
reads: kernel S2 (``vrt_setup``, csrc/setup.cu, one launch a part) for
CUDA tensors, ``setup_packed_plain`` (``raster.setup_components`` and its
packing, the JAX package's plain setup) for CPU tensors.

The work list keeps the JAX package's count (one leading dummy per
supertile plus every overlapping (usable instance, supertile) pair, so
``FrameOutput.num_work_items`` agrees) and drops the same items on
overflow: the first ``max_work`` in supertile-major, near-to-far order
survive. Near-to-far order and item-level early-z are only speed-ups on
the TPU; the kernels here take the items in any order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from vrenderer_tpu_torch.ops import _build, raster
from vrenderer_tpu_torch.ops.raster import F32_FAR, TriSetup
from vrenderer_tpu_torch.profiler import span, sync_copy

NUM_ATTRS = 8
NUM_COEF = 3 * (1 + NUM_ATTRS)    # [inv_w, attr0..7] x (a, b, c)
VIS_STRIDE = 16                   # 3 edges x 3, z plane x 3, bbox x 4
TILE = 128
REGION = 64        # side of the pixel squares the kernels bin to
CHUNK = 16384      # evaluated (triangle, pixel) pairs a raster block's
                   # chunk aims at (kChunk of csrc/raster.cu)
CELL = 8           # side of the kernels' block-test blocks
SMALL_PX = CELL * CELL   # bbox-in-region pixels one thread walks unsplit
_KEY_EMPTY = torch.iinfo(torch.int64).max
# the raster kernel's shared memory: region^2 keys (rounded to 16 bytes)
# and two stage buffers of 256 rows of 64 bytes and their ids, of the 227 KB
# a block may hold on the H100 (less the static part)
_SMEM_BYTES = 232448 - 4096
_STAGE_BYTES = 2 * 256 * (64 + 4)
_MAX_SIDE = 256    # a region's pairs and cost share one 64-bit total
_MAX_SUB = 16      # regions a supertile, (tile / region)^2
_COST_BITS = 38    # a region's total: (entries << 38) | cost
# B3b's per-cell instance bitmap: bench.py's envelope has 4096 terrain
# slots, plus the scene's block slots
MAX_RESOLVE_INSTANCES = 8192
RESOLVE_ROWS = 16  # pixel rows of a supertile one B3b block takes


class PackedTris(NamedTuple):
    """Per-triangle kernel inputs, triangle-major.

    vis:  (I, T, 16) float32, rows e0(a, b, c) e1 e2 z(a, b, c) and the
          inclusive pixel bbox (x0, y0, x1, y1); invalid triangles have
          zero planes and the empty bbox (+FAR, +FAR, -FAR, -FAR).
    coef: (I, T, 27) float32, (a, b, c) of inv_w then attr_k / w; None
          for a depth-only raster, which reads no attribute planes.
    """

    vis: torch.Tensor
    coef: torch.Tensor | None


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
    empty = sync_copy(torch.tensor([F32_FAR, F32_FAR, -F32_FAR, -F32_FAR],
                                   dtype=torch.float32), ok.device)
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


class PackedSetup(NamedTuple):
    """``setup_packed``'s outputs over the parts' instances in order: the
    raster's rows ``tris`` (coef None for parts without attribute
    channels) and the instance bounds of ``instance_bbox_components``,
    bbox (I, 4), usable (I,) and dist (I,)."""

    tris: PackedTris
    bbox: torch.Tensor
    usable: torch.Tensor
    dist: torch.Tensor


SETUP_ATTRS = (0, NUM_ATTRS)   # attribute channels a part may carry
SETUP_W_EPS = 1e-4             # setup_components' near-plane w


def _lattice(world: torch.Tensor, T: int) -> bool:
    """``setup_components``' test for the terrain lattice (I, S, S, 3)."""
    return (world.ndim == 4 and world.shape[1] == world.shape[2]
            and T == (world.shape[1] - 1) ** 2 * 2)


def _check_setup(parts, world_to_clip: torch.Tensor) -> tuple[int, int]:
    """Device, dtype, shape and contiguity of ``setup_packed``'s inputs;
    returns the parts' attribute channels and triangles an instance."""
    def fail(what):
        raise ValueError(f"setup_packed: {what}")

    dev = world_to_clip.device
    if tuple(world_to_clip.shape) != (4, 4):
        fail(f"world_to_clip has shape {tuple(world_to_clip.shape)}, needs "
             f"(4, 4)")
    if not parts:
        fail("no parts")
    A = T = None
    for k, (world, attrs, valid, tri_idx) in enumerate(parts):
        if world.ndim not in (3, 4) or world.shape[-1] != 3:
            fail(f"part {k} world has shape {tuple(world.shape)}, needs "
                 f"(I, V, 3) or (I, S, S, 3)")
        I, T_k = world.shape[0], tri_idx.shape[0]
        if T is not None and T_k != T:
            fail(f"part {k} has {T_k} triangles an instance, part 0 {T}: "
                 f"the raster's rows need one T")
        T = T_k
        A_k = attrs.shape[-1] if attrs.ndim else -1
        if A_k not in SETUP_ATTRS:
            fail(f"part {k} attrs has {A_k} channels, needs one of "
                 f"{SETUP_ATTRS}")
        if A is not None and A_k != A:
            fail(f"part {k} attrs has {A_k} channels, part 0 {A}")
        A = A_k
        expect = [("world", world, world.shape, torch.float32),
                  ("attrs", attrs, world.shape[:-1] + (A,), torch.float32),
                  ("inst_valid", valid, (I,), torch.bool),
                  ("tri_idx", tri_idx, (T, 3), torch.int64)]
        for name, x, shape, dtype in expect:
            if tuple(x.shape) != tuple(shape):
                fail(f"part {k} {name} has shape {tuple(x.shape)}, needs "
                     f"{tuple(shape)}")
            if x.dtype != dtype:
                fail(f"part {k} {name} is {x.dtype}, needs {dtype}")
            if x.device != dev:
                fail(f"part {k} {name} is on {x.device}, world_to_clip on "
                     f"{dev}")
            if not x.is_contiguous():
                fail(f"part {k} {name} is not contiguous")
    if world_to_clip.dtype != torch.float32:
        fail(f"world_to_clip is {world_to_clip.dtype}, needs torch.float32")
    if not world_to_clip.is_contiguous():
        fail("world_to_clip is not contiguous")
    return A, T


def setup_packed_plain(parts, world_to_clip: torch.Tensor, width: int,
                       height: int, y0: float | None = None) -> PackedSetup:
    """``setup_packed`` as the plain chain: ``raster.setup_components`` and
    ``instance_bbox_components`` a part, ``raster.shift_components_y``
    under a band, the stacked parts concatenated, then ``pack_setup`` (8
    attribute channels) or ``pack_vis`` (none)."""
    setups, bboxes, usables, dists = [], [], [], []
    for world, attrs, valid, tri_idx in parts:
        comp = raster.setup_components(world, attrs, valid, tri_idx,
                                       world_to_clip, width, height)
        bbox, usable, dist = instance_bbox_components(comp, width, height,
                                                      valid)
        if y0 is not None:
            bbox = bbox - bbox.new_tensor([0.0, y0, 0.0, y0])
            comp = raster.shift_components_y(comp, y0)
        setups.append(raster.stack_components(comp))
        bboxes.append(bbox)
        usables.append(usable)
        dists.append(dist)
    setup = TriSetup(*(torch.cat(f) for f in zip(*setups)))
    n = sum(p[0].shape[0] for p in parts)
    if setup.planes.shape[1] == 2:
        vis, coef = pack_vis(setup, n), None
    else:
        vis, coef = pack_setup(setup, n)
    return PackedSetup(PackedTris(vis, coef), torch.cat(bboxes),
                       torch.cat(usables), torch.cat(dists))


def setup_packed(parts, world_to_clip: torch.Tensor, width: int, height: int,
                 y0: float | None = None) -> PackedSetup:
    """Triangle setup of ``parts``, each (world, attrs, inst_valid,
    tri_idx) as ``raster.setup_components`` takes them, instances in order:
    the raster's packed rows and the instance bounds the work list reads.
    ``y0``: rows and bounds rebased to the band that starts at that frame
    row, after the bounds are taken. Parts with 8 attribute channels get
    coefficient rows, parts with none only visibility rows. CUDA tensors
    launch the kernel ``vrt_setup`` (csrc/setup.cu) once a part into
    buffers allocated once, counted on ``setup_packed.launches``, with no
    host sync; CPU tensors run ``setup_packed_plain``, which the kernel
    equals bit for bit on the card."""
    A, T = _check_setup(parts, world_to_clip)
    dev = world_to_clip.device
    if dev.type == "cpu":
        return setup_packed_plain(parts, world_to_clip, width, height, y0)
    if dev.type != "cuda":
        raise ValueError(f"setup_packed: the kernel runs on a CUDA device; "
                         f"the inputs are on {dev}")
    return _setup_launches(parts, world_to_clip, width, height, y0, A, T)


setup_packed.launches = 0


def _setup_launches(parts, world_to_clip, width, height, y0, A, T):
    """``setup_packed``'s kernel path on checked inputs: the outputs
    allocated once and one launch of ``vrt_setup`` a part into its rows."""
    dev = world_to_clip.device
    n = sum(p[0].shape[0] for p in parts)
    f32 = dict(dtype=torch.float32, device=dev)
    vis = torch.empty((n, T, VIS_STRIDE), **f32)
    coef = torch.empty((n, T, NUM_COEF), **f32) if A else None
    bbox = torch.empty((n, 4), **f32)
    usable = torch.empty((n,), dtype=torch.bool, device=dev)
    dist = torch.empty((n,), **f32)
    off = 0
    for world, attrs, valid, tri_idx in parts:
        I = world.shape[0]
        if I == 0:
            continue
        side = world.shape[1] if _lattice(world, T) else 0
        _build.launch(
            "vrt_setup", dev, world.data_ptr(), attrs.data_ptr(), A,
            valid.data_ptr(), tri_idx.data_ptr(), side,
            world[0].numel() // 3, T, I, world_to_clip.data_ptr(), width,
            height, SETUP_W_EPS, int(y0 is not None),
            0.0 if y0 is None else float(y0),
            vis.data_ptr() + 4 * off * T * VIS_STRIDE,
            coef.data_ptr() + 4 * off * T * NUM_COEF if A else None,
            bbox.data_ptr() + 16 * off, usable.data_ptr() + off,
            dist.data_ptr() + 4 * off)
        setup_packed.launches += 1
        off += I
    return PackedSetup(PackedTris(vis, coef), bbox, usable, dist)


def _tiles(width: int, height: int, tile: int):
    tiles_x = -(-width // tile)
    return tiles_x, tiles_x * -(-height // tile)


def region_side(tile: int, region: int = REGION, key_bytes: int = 8) -> int:
    """The side of the pixel squares the kernels bin to for ``tile``:
    ``region`` where it divides the tile, else the whole tile. Raises for a
    square whose keys (``key_bytes`` each) and stage buffers do not fit in a
    block's shared memory, and for more than 16 squares a supertile or a
    side above 256."""
    if tile <= 0 or region <= 0:
        raise ValueError(f"tile {tile} and region {region} must be positive")
    side = region if tile % region == 0 else tile
    keys = -(-side * side * key_bytes // 16) * 16
    if keys + _STAGE_BYTES > _SMEM_BYTES:
        raise ValueError(f"a {side}x{side} px region of {key_bytes}-byte keys "
                         f"does not fit in shared memory (tile {tile}, "
                         f"region {region})")
    if side > _MAX_SIDE or (tile // side) ** 2 > _MAX_SUB:
        raise ValueError(f"{side}-px regions of a {tile}-px supertile: at "
                         f"most {_MAX_SIDE} px and {_MAX_SUB} a supertile")
    return side


@functools.lru_cache(maxsize=256)
def _scratch_layout(n_items: int, T: int, tiles_x: int, tile: int,
                    side: int, width: int, height: int, key_bytes: int):
    """(bytes, offsets) of ``vrt_raster_scratch`` for one call's shapes,
    asked of the library once per shape."""
    import ctypes

    offsets = (ctypes.c_longlong * 5)()
    n = _build.load().vrt_raster_scratch(n_items, T, tiles_x, tile, side,
                                         width, height, key_bytes, offsets)
    return n, tuple(offsets)


def _scratch(vis: torch.Tensor, work: WorkList, width: int, height: int,
             tile: int, side: int, key_bytes: int):
    """The kernels' scratch buffer for one call (uninitialised; the binning
    clears what it counts in) and its byte offsets of the header, the
    regions' totals, first entries, first chunks and the entries
    (``vrt_raster_scratch``). Raises for shapes the kernels cannot take."""
    tiles_x, _ = _tiles(width, height, tile)
    n_items, T = work.items.shape[0], vis.shape[1]
    if n_items * T >= 1 << (64 - _COST_BITS) or (
            n_items * T * side * side >= 1 << _COST_BITS):
        raise ValueError(f"{n_items} work items of {T} triangles pass the "
                         f"binning's counters")
    n, offsets = _scratch_layout(n_items, T, tiles_x, tile, side, width,
                                 height, key_bytes)
    if n < 0:
        raise ValueError(f"the raster kernels cannot take {n_items} items "
                         f"of {T} triangles at {width}x{height} (tile {tile},"
                         f" region {side})")
    buf = torch.empty(n, dtype=torch.uint8, device=vis.device)
    return buf, offsets


def _aligned(vis: torch.Tensor):
    if vis.data_ptr() % 16:
        raise ValueError("the raster kernels stage 16-byte rows: vis must "
                         "be 16-byte aligned")


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
    with span("Sync"):                  # the count goes to the host
        kept = (ovl & (pos[:, 1:] < max_work)).nonzero()   # row-major order
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


def _zid_outputs(width: int, height: int, device: torch.device):
    """Empty z (H, W) float32 and id (H, W) int32."""
    return (torch.empty((height, width), dtype=torch.float32, device=device),
            torch.empty((height, width), dtype=torch.int32, device=device))


def rasterize(packed: PackedTris, work: WorkList, width: int, height: int,
              tile: int = TILE, reverse_z: bool = False,
              wire_px: float = 0.0, region: int = REGION):
    """Returns (z (H, W) float32, background F32_FAR, -F32_FAR under
    ``reverse_z``; id (H, W) int32, -1 background; attrs (H, W, 8) float32,
    perspective-divided, 0 on the background). CUDA tensors launch kernel
    B1 (its binning launches and its raster launch, one counted launch),
    CPU tensors run ``rasterize_plain``. ``region`` (``region_side``)
    shapes only the kernel's blocks, never the result."""
    device = packed.vis.device
    _check(packed.vis, packed.coef, work)
    side = region_side(tile, region)
    if device.type == "cpu":
        return rasterize_plain(packed, work, width, height, tile, reverse_z,
                               wire_px)
    vis, coef = packed
    _aligned(vis)
    buf, _ = _scratch(vis, work, width, height, tile, side, 8)
    z, ids = _zid_outputs(width, height, device)
    attrs = torch.empty((height, width, NUM_ATTRS), dtype=torch.float32,
                        device=device)
    tiles_x, _ = _tiles(width, height, tile)
    _build.launch("vrt_raster", device, vis.data_ptr(), coef.data_ptr(),
                  work.items.data_ptr(), work.items.shape[0], vis.shape[1],
                  tiles_x, tile, side, width, height, int(reverse_z),
                  float(wire_px), buf.data_ptr(), buf.numel(),
                  z.data_ptr(), ids.data_ptr(), attrs.data_ptr())
    rasterize.launches += 1
    return z, ids, attrs


rasterize.launches = 0


def rasterize_zid(packed: PackedTris, work: WorkList, width: int,
                  height: int, tile: int = TILE, reverse_z: bool = False,
                  region: int = REGION):
    """Two-phase phase 1: (z, id) exactly as ``rasterize`` returns them,
    without the attributes. CUDA tensors launch kernel B3a, CPU tensors run
    ``rasterize_zid_plain``."""
    device = packed.vis.device
    _check(packed.vis, packed.coef, work)
    side = region_side(tile, region)
    if device.type == "cpu":
        return rasterize_zid_plain(packed, work, width, height, tile,
                                   reverse_z)
    _aligned(packed.vis)
    buf, _ = _scratch(packed.vis, work, width, height, tile, side, 8)
    z, ids = _zid_outputs(width, height, device)
    tiles_x, _ = _tiles(width, height, tile)
    _build.launch("vrt_raster_zid", device, packed.vis.data_ptr(),
                  work.items.data_ptr(), work.items.shape[0],
                  packed.vis.shape[1], tiles_x, tile, side, width, height,
                  int(reverse_z), buf.data_ptr(),
                  buf.numel(), z.data_ptr(), ids.data_ptr())
    rasterize_zid.launches += 1
    return z, ids


rasterize_zid.launches = 0


def _cell_grid(tile: int, sub_h: int, win_w: int):
    """(rows, columns) of sub_h x win_w cells in a supertile."""
    if tile % sub_h or tile % win_w:
        raise ValueError(f"cells of {sub_h}x{win_w} px do not tile a "
                         f"{tile}-px supertile")
    return tile // sub_h, tile // win_w


def _resolve_band(tile: int, sub_h: int) -> int:
    """The pixel rows of a supertile one B3b block takes: RESOLVE_ROWS
    where it is a multiple of ``sub_h`` dividing the tile, else one cell
    row."""
    if RESOLVE_ROWS % sub_h == 0 and tile % RESOLVE_ROWS == 0:
        return RESOLVE_ROWS
    return sub_h


def _check_two_phase(device: torch.device, *expect):
    """Each (tensor, shape, dtype) of ``expect`` lies contiguous on
    ``device`` with that shape and dtype."""
    for x, shape, dtype in expect:
        if (x.device != device or tuple(x.shape) != shape
                or x.dtype != dtype or not x.is_contiguous()):
            raise ValueError(f"two-phase input {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}, expected contiguous {shape} "
                             f"{dtype} on {device}")


def filter_work_to_winners(work: WorkList, ids: torch.Tensor,
                           tris_per_inst: int, width: int, height: int,
                           tile: int = TILE, sub_h: int = 16,
                           win_w: int = 128):
    """Two-phase: which (work item, cell) pairs may own a phase-1 winner
    (the rule: ``filter_work_to_winners_plain``). Returns the work list
    with items that have no live cell marked unused (-1, -1),
    ``num_items`` unchanged, and the (max_work, n_cell) bool live mask.
    CUDA tensors launch the kernel ``vrt_filter_winners`` (one launch, no
    host synchronisation), CPU tensors run the plain version."""
    n_sub, n_win = _cell_grid(tile, sub_h, win_w)
    device = ids.device
    n = work.items.shape[0]
    _check_two_phase(device, (work.items, (n, 2), torch.int32),
                     (ids, (height, width), torch.int32))
    if device.type == "cpu":
        return filter_work_to_winners_plain(work, ids, tris_per_inst, width,
                                            height, tile, sub_h, win_w)
    items = torch.empty_like(work.items)
    live = torch.empty((n, n_sub * n_win), dtype=torch.bool, device=device)
    tiles_x, _ = _tiles(width, height, tile)
    _build.launch("vrt_filter_winners", device, work.items.data_ptr(), n,
                  ids.data_ptr(), tris_per_inst, tiles_x, tile, sub_h, win_w,
                  width, height, items.data_ptr(), live.data_ptr())
    filter_work_to_winners.launches += 1
    return WorkList(items=items, num_items=work.num_items), live


filter_work_to_winners.launches = 0


def rasterize_resolve(packed: PackedTris, work: WorkList, live: torch.Tensor,
                      ids: torch.Tensor, width: int, height: int,
                      tile: int = TILE, sub_h: int = 16, win_w: int = 128
                      ) -> torch.Tensor:
    """Two-phase phase 2: attrs (H, W, 8) of the winners ``ids`` (from
    ``rasterize_zid``) where their item is live at the pixel's cell (the
    rule: ``rasterize_resolve_plain``), 0 elsewhere. CUDA tensors launch
    kernel B3b, CPU tensors run ``rasterize_resolve_plain``. Raises for
    more than MAX_RESOLVE_INSTANCES instance slots on every device."""
    device = packed.vis.device
    _check(packed.vis, packed.coef, work)
    n_sub, n_win = _cell_grid(tile, sub_h, win_w)
    _check_two_phase(device, (live, (work.items.shape[0], n_sub * n_win),
                              torch.bool),
                     (ids, (height, width), torch.int32))
    I, T = packed.coef.shape[0], packed.coef.shape[1]
    if I > MAX_RESOLVE_INSTANCES:
        raise ValueError(f"{I} instance slots: the resolve takes at most "
                         f"{MAX_RESOLVE_INSTANCES}")
    if device.type == "cpu":
        return rasterize_resolve_plain(packed, work, live, ids, width, height,
                                       tile, sub_h, win_w)
    attrs = torch.empty((height, width, NUM_ATTRS), dtype=torch.float32,
                        device=device)
    tiles_x, _ = _tiles(width, height, tile)
    _build.launch("vrt_raster_resolve", device, packed.coef.data_ptr(),
                  work.items.data_ptr(), live.data_ptr(), work.items.shape[0],
                  I, T, tiles_x, tile, sub_h, win_w,
                  _resolve_band(tile, sub_h), width, height, ids.data_ptr(),
                  attrs.data_ptr())
    rasterize_resolve.launches += 1
    return attrs


rasterize_resolve.launches = 0


def rasterize_two_phase(packed: PackedTris, work: WorkList, width: int,
                        height: int, tile: int = TILE, sub_h: int = 16,
                        win_w: int = 128, reverse_z: bool = False):
    """Two-phase rasterization (``raster_pallas.rasterize_pallas_two_phase``):
    B3a, the winner filter, then B3b. Returns (z, id, attrs), bit-identical
    to ``rasterize(..., reverse_z=reverse_z)``."""
    z, ids = rasterize_zid(packed, work, width, height, tile, reverse_z)
    work2, live = filter_work_to_winners(work, ids, packed.vis.shape[1],
                                         width, height, tile, sub_h, win_w)
    attrs = rasterize_resolve(packed, work2, live, ids, width, height, tile,
                              sub_h, win_w)
    return z, ids, attrs


def rasterize_depth(vis: torch.Tensor, work: WorkList, width: int,
                    height: int, tile: int = TILE,
                    region: int = REGION) -> torch.Tensor:
    """Depth-only raster of the visibility rows ``vis`` (I, T, 16): z
    (H, W) float32 of the nearest covered triangle, F32_FAR where none
    covers. CUDA tensors launch kernel B2, CPU tensors run
    ``rasterize_depth_plain``."""
    device = vis.device
    _check(vis, None, work)
    side = region_side(tile, region, key_bytes=4)
    if device.type == "cpu":
        return rasterize_depth_plain(vis, work, width, height, tile)
    _aligned(vis)
    buf, _ = _scratch(vis, work, width, height, tile, side, 4)
    z = torch.empty((height, width), dtype=torch.float32, device=device)
    tiles_x, _ = _tiles(width, height, tile)
    _build.launch("vrt_raster_depth", device, vis.data_ptr(),
                  work.items.data_ptr(), work.items.shape[0], vis.shape[1],
                  tiles_x, tile, side, width, height, buf.data_ptr(),
                  buf.numel(), z.data_ptr())
    rasterize_depth.launches += 1
    return z


rasterize_depth.launches = 0


def winner_rows(coef: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """B1's output gather alone (kernel ``vrt_raster_gather``, the code of
    B1's output pass, where a warp loads its 32 winners' rows together):
    (n, 27) float32, row i the coefficients of triangle ``ids[i]`` of
    ``coef`` (I, T, 27), zeros where ``ids[i] < 0``. For timing the gather
    against a library gather; the frame path runs it inside B1. CPU tensors
    run ``winner_rows_plain``."""
    n = ids.numel()
    if (coef.dim() != 3 or coef.shape[2] != NUM_COEF
            or coef.dtype != torch.float32 or ids.dtype != torch.int32
            or coef.device != ids.device or not coef.is_contiguous()
            or not ids.is_contiguous()):
        raise ValueError(f"winner_rows: coef {tuple(coef.shape)} "
                         f"{coef.dtype}, ids {ids.dtype} on {coef.device} "
                         f"and {ids.device}, expected contiguous (I, T, 27) "
                         f"float32 and int32 on one device")
    if ids.device.type == "cpu":
        return winner_rows_plain(coef, ids)
    out = torch.empty((n, NUM_COEF), dtype=torch.float32, device=ids.device)
    _build.launch("vrt_raster_gather", ids.device, coef.data_ptr(),
                  ids.data_ptr(), n, out.data_ptr())
    winner_rows.launches += 1
    return out


winner_rows.launches = 0


def winner_rows_plain(coef: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``winner_rows``."""
    flat = ids.reshape(-1).long()
    rows = coef.reshape(-1, NUM_COEF)[flat.clamp(min=0)]
    return torch.where((flat >= 0)[:, None], rows, torch.zeros_like(rows))


class DeviceBins(NamedTuple):
    """The card's bins of one call, read back (``device_bins``): per region
    of the frame's row-major grid of ``side``-px squares its entries, their
    summed cost and its chunks (the blocks its work was split across); the
    entries whose rect passed SMALL_PX pixels (``n_large``, () int32)."""

    entries: torch.Tensor
    cost: torch.Tensor
    chunks: torch.Tensor
    side: int
    scratch_bytes: int
    n_large: torch.Tensor


def device_bins(vis: torch.Tensor, work: WorkList, width: int, height: int,
                tile: int = TILE, key_bytes: int = 8,
                region: int = REGION) -> DeviceBins:
    """Runs the binning launches of B1 (``key_bytes`` 8, B3a the same) or
    B2 (4) alone on the card and reads their per-region results back (for
    chip_smoke: the busiest region, the blocks it was split across, the
    binning's time). Not counted as a kernel launch: no raster runs."""
    _check(vis, None, work)
    side = region_side(tile, region, key_bytes=key_bytes)
    _aligned(vis)
    buf, off = _scratch(vis, work, width, height, tile, side, key_bytes)
    tiles_x, _ = _tiles(width, height, tile)
    _build.launch("vrt_raster_bins", vis.device, vis.data_ptr(),
                  work.items.data_ptr(), work.items.shape[0], vis.shape[1],
                  tiles_x, tile, side, width, height, key_bytes,
                  buf.data_ptr(), buf.numel())
    n_regions = -(-width // side) * -(-height // side)

    def ints(at, n, dtype):
        size = torch.tensor([], dtype=dtype).element_size()
        return buf[at:at + n * size].view(dtype)

    total = ints(off[1], n_regions, torch.int64)
    cstart = ints(off[3], n_regions + 1, torch.int32)
    # the header's ints: next chunk, chunks, split regions, large rects
    return DeviceBins(entries=(total >> _COST_BITS) & ((1 << 26) - 1),
                      cost=total & ((1 << _COST_BITS) - 1),
                      chunks=(cstart[1:] - cstart[:-1]).long(), side=side,
                      scratch_bytes=buf.numel(),
                      n_large=ints(off[0], 4, torch.int32)[3])


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


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _blocks_live(pc: torch.Tensor, bx0, by0, bx1, by1) -> torch.Tensor:
    """The kernels' block test (csrc/raster.cu ``block_live``, same
    roundings): False where no pixel centre of block [bx0, bx1] x [by0,
    by1] can be covered by the planes ``pc`` (n, 12); triangles with a NaN
    plane float cover nothing."""
    pxa, pxb = bx0.float() + 0.5, bx1.float() + 0.5
    pya, pyb = by0.float() + 0.5, by1.float() + 0.5
    scale, floor = _f32(2.0 ** -20, pc), _f32(1e-30, pc)
    live = ~torch.isnan(pc).any(dim=1)
    for j in (0, 3, 6, 9):
        a, b, c = pc[:, j], pc[:, j + 1], pc[:, j + 2]
        v = torch.stack([a * px + b * py + c
                         for px, py in ((pxa, pya), (pxb, pya), (pxa, pyb),
                                        (pxb, pyb))])
        m = (a.abs() * pxb + b.abs() * pyb + c.abs()) * scale + floor
        live &= ~(v.amax(dim=0) < -m)
        if j == 9:
            live &= ~(v.amin(dim=0) > _f32(1.01, pc) + m)
    return live


def _blocks(r: PairRects):
    """Rects ``r`` cut into CELL x CELL blocks from their top-left: each
    block's rect index, inclusive corners and whether the block test keeps
    it."""
    x0, y0, wd = r.x0, r.y0, r.wd
    ht = r.cnt // wd
    nbx = (wd + CELL - 1) // CELL
    nb = nbx * ((ht + CELL - 1) // CELL)
    rep = torch.repeat_interleave(torch.arange(nb.numel(), device=nb.device),
                                  nb)
    local = (torch.arange(rep.numel(), device=nb.device)
             - (torch.cumsum(nb, 0) - nb)[rep])
    bx0 = x0[rep] + local % nbx[rep] * CELL
    by0 = y0[rep] + local // nbx[rep] * CELL
    bx1 = torch.minimum(bx0 + CELL, (x0 + wd)[rep]) - 1
    by1 = torch.minimum(by0 + CELL, (y0 + ht)[rep]) - 1
    return rep, bx0, by0, bx1, by1, _blocks_live(r.planes[rep], bx0, by0,
                                                 bx1, by1)


def _split_blocks(r: PairRects) -> PairRects:
    """Rects ``r`` cut into CELL x CELL blocks from their top-left, keeping
    the blocks that pass the block test."""
    rep, bx0, by0, bx1, by1, live = _blocks(r)
    rep = rep[live]
    wb = (bx1 - bx0 + 1)[live]
    return PairRects(x0=bx0[live], y0=by0[live], wd=wb,
                     cnt=wb * (by1 - by0 + 1)[live], gid=r.gid[rep],
                     planes=r.planes[rep])


def _live_pixels(r: PairRects) -> torch.Tensor:
    """Per rect, the pixels of its blocks that the block test keeps."""
    rep, bx0, by0, bx1, by1, live = _blocks(r)
    px = (bx1 - bx0 + 1) * (by1 - by0 + 1)
    return torch.zeros_like(r.cnt).index_add_(0, rep[live], px[live])


def block_pair_rects(vis: torch.Tensor, work: WorkList, width: int,
                     height: int, tile: int = TILE,
                     region: int = REGION) -> PairRects:
    """The (triangle, pixel) pairs kernels B1, B2 and B3a evaluate, as
    rects: each triangle's bbox ∩ region (``region_side``) whole where it
    holds at most SMALL_PX pixels, else the CELL x CELL blocks of it that
    the block test keeps. ``cnt.sum()`` is the evaluated pair count; the
    covered pairs are those of ``pair_rects``."""
    side = region_side(tile, region, key_bytes=4)
    k = tile // side
    tiles_x, _ = _tiles(width, height, tile)
    items = work.items[work.items[:, 0] >= 0].long()
    sub = torch.arange(k * k, device=items.device)
    inst = items[:, 0:1].expand(-1, k * k).reshape(-1)
    st = items[:, 1:2]
    rx0 = ((st % tiles_x) * tile + sub % k * side).reshape(-1)
    ry0 = ((st // tiles_x) * tile + sub // k * side).reshape(-1)
    inside = (rx0 < width) & (ry0 < height)
    inst, rx0, ry0 = inst[inside], rx0[inside], ry0[inside]
    x0w, y0w = rx0.float()[:, None], ry0.float()[:, None]
    x1w = torch.clamp(x0w + side, max=width) - 1
    y1w = torch.clamp(y0w + side, max=height) - 1
    parts = []
    step = max(1, (1 << 19) // max(vis.shape[1], 1))
    for lo in range(0, inst.numel(), step):
        sl = slice(lo, lo + step)
        r = _window_rects(vis, inst[sl], x0w[sl], y0w[sl], x1w[sl], y1w[sl])
        some = (r.wd > 0) & (r.cnt > 0)
        small = some & (r.cnt <= SMALL_PX)
        big = some & (r.cnt > SMALL_PX)
        parts += [PairRects(*(f[small] for f in r)),
                  _split_blocks(PairRects(*(f[big] for f in r)))]
    if not parts:
        return _window_rects(vis, inst, x0w, y0w, x1w, y1w)
    return PairRects(*(torch.cat(f) for f in zip(*parts)))


class RegionBins(NamedTuple):
    """The binning of kernels B1, B2 and B3a in plain PyTorch
    (``region_bins``): per entry, a triangle whose bbox meets a region of
    the frame's row-major grid of ``side``-px squares within its work
    item's supertile (once for each item that lists it), its global id and
    its cost, the pairs the kernels evaluate there (the bbox-in-region
    pixels, or above SMALL_PX those of the CELL x CELL blocks the block test
    keeps); entries grouped by region, region r's at ``start[r]:start[r +
    1]`` in work-list order, and each region's summed cost."""

    start: torch.Tensor
    gid: torch.Tensor
    cost: torch.Tensor
    region_cost: torch.Tensor
    side: int


def region_bins(vis: torch.Tensor, work: WorkList, width: int, height: int,
                tile: int = TILE, region: int = REGION) -> RegionBins:
    """The kernels' bins of (``vis``, ``work``), as the binning launches
    build them on the card (csrc/raster.cu ``bins_kernel``; the card lists
    a region's entries in another order). Items are taken in any order;
    unused slots and supertiles outside the frame list nothing."""
    side = region_side(tile, region, key_bytes=4)
    k = tile // side
    tiles_x, n_st = _tiles(width, height, tile)
    regions_x = -(-width // side)
    n_regions = regions_x * -(-height // side)
    it = work.items.long()
    items = it[(it[:, 0] >= 0) & (it[:, 1] >= 0) & (it[:, 1] < n_st)]
    sub = torch.arange(k * k, device=items.device)
    inst = items[:, 0:1].expand(-1, k * k).reshape(-1)
    st = items[:, 1:2]
    rx0 = ((st % tiles_x) * tile + sub % k * side).reshape(-1)
    ry0 = ((st // tiles_x) * tile + sub // k * side).reshape(-1)
    inside = (rx0 < width) & (ry0 < height)
    inst, rx0, ry0 = inst[inside], rx0[inside], ry0[inside]
    ridx = ry0 // side * regions_x + rx0 // side
    x0w, y0w = rx0.float()[:, None], ry0.float()[:, None]
    x1w = torch.clamp(x0w + side, max=width) - 1
    y1w = torch.clamp(y0w + side, max=height) - 1
    regions, gids, costs = [], [], []
    step = max(1, (1 << 19) // max(vis.shape[1], 1))
    for lo in range(0, inst.numel(), step):
        sl = slice(lo, lo + step)
        w_i, r = _window_hits(vis, inst[sl], x0w[sl], y0w[sl], x1w[sl],
                              y1w[sl])
        some = (r.wd > 0) & (r.cnt > 0)
        w_i, r = w_i[some], PairRects(*(f[some] for f in r))
        cost = r.cnt.clone()
        big = r.cnt > SMALL_PX
        cost[big] = _live_pixels(PairRects(*(f[big] for f in r)))
        regions.append(ridx[sl][w_i])
        gids.append(r.gid)
        costs.append(cost)
    dev = vis.device
    region_of = torch.cat(regions) if regions else torch.zeros(
        0, dtype=torch.long, device=dev)
    gid = torch.cat(gids) if gids else torch.zeros_like(region_of)
    cost = torch.cat(costs) if costs else torch.zeros_like(region_of)
    order = torch.sort(region_of, stable=True).indices
    counts = torch.bincount(region_of, minlength=n_regions)
    start = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                       torch.cumsum(counts, 0)])
    return RegionBins(start=start, gid=gid[order], cost=cost[order],
                      region_cost=torch.zeros(n_regions, dtype=torch.long,
                                              device=dev).index_add_(
                          0, region_of, cost),
                      side=side)


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


def rasterize_zid_plain(packed: PackedTris, work: WorkList, width: int,
                        height: int, tile: int = TILE,
                        reverse_z: bool = False, chunk: int = 1 << 21):
    """Plain PyTorch version of kernel B3a: ``rasterize_plain``'s z and
    id."""
    keys = _merge_keys_plain(packed.vis, work, width, height, tile,
                             reverse_z, 0.0, chunk)
    return _decode_plain(keys, width, height, reverse_z)


def filter_work_to_winners_plain(work: WorkList, ids: torch.Tensor,
                                 tris_per_inst: int, width: int, height: int,
                                 tile: int = TILE, sub_h: int = 16,
                                 win_w: int = 128):
    """Plain PyTorch version of the filter kernel. Cells are the sub_h x
    win_w pixel blocks of each supertile, row-major (cell c at block row c
    // (tile // win_w)). Per cell, the winners' instances ``id // T`` span
    [min, max]; a pair is live iff the item's instance lies in that range,
    the JAX package's conservative rule
    (``raster_pallas.filter_work_to_winners``): every winner's own item
    stays live. ``ids`` is the cropped (H, W) id image, -1 background; the
    padding to supertile multiples is background, so a cell wholly outside
    the frame is never live. No host synchronisation."""
    n_sub, n_win = _cell_grid(tile, sub_h, win_w)
    tiles_x, n_st = _tiles(width, height, tile)
    pad = torch.full((n_st // tiles_x * tile, tiles_x * tile), -1,
                     dtype=ids.dtype, device=ids.device)
    pad[:height, :width] = ids
    bg = pad < 0
    inst = torch.div(pad, tris_per_inst, rounding_mode="floor")
    blocks = (pad.shape[0] // sub_h, sub_h, pad.shape[1] // win_w, win_w)
    mn = torch.where(bg, 2 ** 30, inst).reshape(blocks).amin(dim=(1, 3))
    mx = torch.where(bg, -1, inst).reshape(blocks).amax(dim=(1, 3))

    item_inst = work.items[:, 0:1].long()
    st = work.items[:, 1:2].long().clamp(min=0)
    c = torch.arange(n_sub * n_win, device=ids.device)[None, :]
    rows = (st // tiles_x) * n_sub + c // n_win
    cols = (st % tiles_x) * n_win + c % n_win
    live = ((mn[rows, cols] <= item_inst) & (item_inst <= mx[rows, cols])
            & (item_inst >= 0))
    items = torch.where(live.any(dim=1, keepdim=True), work.items,
                        torch.full_like(work.items, -1))
    return WorkList(items=items, num_items=work.num_items), live


def rasterize_resolve_plain(packed: PackedTris, work: WorkList,
                            live: torch.Tensor, ids: torch.Tensor,
                            width: int, height: int, tile: int = TILE,
                            sub_h: int = 16, win_w: int = 128
                            ) -> torch.Tensor:
    """Plain PyTorch version of kernel B3b: a covered pixel gets its
    winner's attributes iff some slot of ``work`` holds the item (winner's
    instance, pixel's supertile) with its ``live`` byte set at the pixel's
    cell (any live copy, for an item listed twice), else 0."""
    dev = ids.device
    I, T = packed.coef.shape[0], packed.coef.shape[1]
    n_sub, n_win = _cell_grid(tile, sub_h, win_w)
    tiles_x, n_st = _tiles(width, height, tile)
    # live cells of each (instance, supertile), summed over its slots;
    # unused slots add to a spare row that nothing reads
    inst_w, st_w = work.items[:, 0].long(), work.items[:, 1].long()
    key = torch.where(inst_w >= 0, inst_w * n_st + st_w, I * n_st)
    won = torch.zeros((I * n_st + 1, n_sub * n_win), dtype=torch.int32,
                      device=dev).index_add_(0, key, live.to(torch.int32))
    y = torch.arange(height, device=dev)[:, None]
    x = torch.arange(width, device=dev)[None, :]
    st = (y // tile) * tiles_x + x // tile
    cell = ((y % tile) // sub_h) * n_win + (x % tile) // win_w
    covered = ids >= 0
    inst = torch.where(covered, ids.long() // T, torch.zeros_like(st))
    write = covered & (won[inst * n_st + st, cell] > 0)
    return _attrs_plain(packed.coef, ids, write)


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
