"""Vectorized CDLOD quadtree selection (QuadTree::NodeSelect,
QuadTree.cpp:80-131), as in ``vrenderer_tpu.terrain.quadtree``: a
level-synchronous masked sweep over a 16x16-node window per level, which
also returns the per-level selected and culled masks of the reference's
quadtree debug view (``SelectionDebug``).

Selected nodes are compacted in level-major, row-major order with an
order-preserving boolean mask, so instance slot ``i`` holds the same node
as in the JAX package (prim ids are ``slot * tris_per_instance + t``).

``select_nodes`` and ``select_all_surfaces`` run their plain versions
(``select_nodes_plain``, ``select_all_surfaces_plain``: the sweep, the CPU
path and the card's reference) for CPU tensors, and for CUDA tensors
launch the hand-written kernel ``vrt_select`` of ``csrc/select.cu``
(``select_cuda``): the whole selection and its compaction in one launch,
bit-identical to the sweep, with no host synchronisation. The sweep issues
about 90 small launches a level and syncs once for each compacted field.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vrenderer_tpu_torch.config import TerrainSettings
from vrenderer_tpu_torch.ops import _build
from vrenderer_tpu_torch.profiler import span
from vrenderer_tpu_torch.utils import math3d


class SelectedInstances(NamedTuple):
    """Fixed-capacity selection (the reference's InstanceData array,
    TerrainPass.cpp:234-256)."""

    position: torch.Tensor  # (cap, 3) node centre (y = 0)
    extents: torch.Tensor   # (cap, 3) node extents (y = 0)
    lod: torch.Tensor       # (cap,) int32
    valid: torch.Tensor     # (cap,) bool
    count: torch.Tensor     # () int32, total selected (may exceed cap)


class SelectionDebug(NamedTuple):
    """Per-level masks over the selection windows, the reference's
    m_DebugDrawData (QuadTree.h:122-126)."""

    selected: torch.Tensor  # (L+1, w, w) bool
    culled: torch.Tensor    # (L+1, w, w) bool, visited but frustum-culled
    origin: torch.Tensor    # (L+1, 2) int32 window origin (cell x, z)


def select_nodes(settings: TerrainSettings, camera_pos: torch.Tensor,
                 frustum_planes: torch.Tensor, lod_ranges: torch.Tensor
                 ) -> tuple[SelectedInstances, SelectionDebug]:
    """CDLOD selection for one quadtree surface centred at the origin
    (TerrainPass.cpp:176-186): the instances and the debug masks. CUDA
    tensors launch ``vrt_select``, CPU tensors run ``select_nodes_plain``
    (which also takes a surface centred elsewhere)."""
    if camera_pos.device.type == "cpu":
        return select_nodes_plain(settings, camera_pos, frustum_planes,
                                  lod_ranges)
    return select_cuda(settings, camera_pos, frustum_planes, lod_ranges)


def select_nodes_plain(settings: TerrainSettings, camera_pos: torch.Tensor,
                       frustum_planes: torch.Tensor, lod_ranges: torch.Tensor,
                       surface_location: torch.Tensor | None = None
                       ) -> tuple[SelectedInstances, SelectionDebug]:
    """``select_nodes`` as a sweep of tensor operations, on any device."""
    dev = camera_pos.device
    W = float(settings.surface_size)
    L = settings.num_lods
    w = settings.select_window
    loc = (torch.zeros(3, dtype=torch.float32, device=dev)
           if surface_location is None else surface_location)
    cam = camera_pos
    r2 = lod_ranges * lod_ranges          # QuadTree.cpp:82 passes range^2
    # the camera's (x, z) cell at every level at once: x / (W / n) is
    # divided as (x * n) / W, the same correctly rounded quotient (n = 2^d),
    # by a divisor on the device
    n_all = torch.bitwise_left_shift(1, torch.arange(L + 1, device=dev))
    cam_cells = torch.floor(math3d.div_rn(
        (cam[0::2] - loc[0::2] + W * 0.5) * n_all[:, None].to(torch.float32),
        W)).to(torch.int32)

    ii = torch.arange(w, dtype=torch.int32, device=dev)
    cz, cx = torch.meshgrid(ii, ii, indexing="ij")

    sel_masks, cull_masks, origins, positions, extents_l = [], [], [], [], []
    recurse_prev = origin_prev = None
    for d in range(L + 1):
        lod = L - d
        n = 1 << d
        cell = W / n
        half = cell * 0.5

        cam_cell_x, cam_cell_z = cam_cells[d]
        ox = torch.clamp(cam_cell_x - w // 2, 0, max(0, n - w))
        oz = torch.clamp(cam_cell_z - w // 2, 0, max(0, n - w))

        gx = ox + cx
        gz = oz + cz
        in_grid = (gx < n) & (gz < n)

        px = loc[0] - W * 0.5 + (gx.to(torch.float32) + 0.5) * cell
        pz = loc[2] - W * 0.5 + (gz.to(torch.float32) + 0.5) * cell
        zeros = torch.zeros_like(px)
        bmin = torch.stack([px - half, zeros, pz - half], dim=-1)
        bmax = torch.stack([px + half, cam[1].expand_as(px), pz + half], dim=-1)

        d2 = math3d.aabb_dist2_xz(cam, bmin, bmax)
        in_range_self = (d2 <= r2[lod]) & in_grid
        in_frustum = math3d.frustum_intersects_box(frustum_planes, bmin, bmax)

        if d == 0:
            visited = in_grid
        else:
            pwx = (gx >> 1) - origin_prev[0]
            pwz = (gz >> 1) - origin_prev[1]
            ok = (pwx >= 0) & (pwx < w) & (pwz >= 0) & (pwz < w)
            pwx = torch.clamp(pwx, 0, w - 1).long()
            pwz = torch.clamp(pwz, 0, w - 1).long()
            visited = recurse_prev[pwz, pwx] & ok & in_grid

        if lod > 0:
            in_range_finer = (d2 <= r2[lod - 1]) & in_grid
            self_sel = visited & in_range_self & in_frustum & ~in_range_finer
            recurse = visited & in_range_self & in_frustum & in_range_finer
        else:
            self_sel = visited & in_range_self & in_frustum
            recurse = torch.zeros_like(visited)
        # a parent emits a child whose NodeSelect returns false
        # (QuadTree.cpp:122-126); not frustum tested, as in the reference
        emitted = (torch.zeros_like(visited) if d == 0
                   else visited & ~in_range_self)

        sel_masks.append(self_sel | emitted)
        cull_masks.append(visited & in_range_self & ~in_frustum)
        origins.append(torch.stack([ox, oz]))
        positions.append(torch.stack([px, zeros, pz], dim=-1))
        extents_l.append(torch.stack(
            [torch.full_like(px, half), zeros, torch.full_like(px, half)],
            dim=-1))
        recurse_prev = recurse
        origin_prev = (ox, oz)

    sel = torch.stack(sel_masks)
    lods = (L - torch.arange(L + 1, dtype=torch.int32, device=dev))
    lods = lods[:, None, None].expand(sel.shape)
    instances = _pack_instances(settings, sel, torch.stack(positions),
                                torch.stack(extents_l), lods)
    return instances, SelectionDebug(selected=sel,
                                     culled=torch.stack(cull_masks),
                                     origin=torch.stack(origins))


def _compact(mask: torch.Tensor, cap: int, *fields: torch.Tensor):
    """Order-preserving compaction of the rows of each field where ``mask``
    holds, truncated to ``cap`` and zero-padded to exactly ``cap`` rows."""
    out = []
    for x in fields:
        with span("Sync"):              # the count goes to the host
            kept = x[mask][:cap]
        pad = torch.zeros((cap - kept.shape[0],) + kept.shape[1:],
                          dtype=x.dtype, device=x.device)
        out.append(torch.cat([kept, pad]))
    return out


def _pack_instances(settings: TerrainSettings, sel, pos, ext, lods
                    ) -> SelectedInstances:
    """Compact selected nodes into the fixed-cap instance array, level-major
    (coarse -> fine) and row-major within a level."""
    cap = settings.max_instances
    m = sel.reshape(-1)
    count = m.sum(dtype=torch.int32)
    position, extents, lod = _compact(
        m, cap, pos.reshape(-1, 3), ext.reshape(-1, 3), lods.reshape(-1))
    valid = torch.arange(cap, device=m.device) < torch.clamp(count, max=cap)
    return SelectedInstances(position, extents, lod, valid, count)


def single_tile_instances(settings: TerrainSettings, device=None
                          ) -> SelectedInstances:
    """One root-node instance covering the whole surface (BASELINE.md
    config 1: a single flat tile, no LOD machinery), for
    ``Renderer.render_locked``."""
    cap = settings.max_instances
    half = settings.surface_size / 2.0
    extents = torch.zeros((cap, 3), dtype=torch.float32, device=device)
    extents[0, 0] = half
    extents[0, 2] = half
    lod = torch.zeros((cap,), dtype=torch.int32, device=device)
    lod[0] = settings.num_lods
    valid = torch.zeros((cap,), dtype=torch.bool, device=device)
    valid[0] = True
    return SelectedInstances(
        position=torch.zeros((cap, 3), dtype=torch.float32, device=device),
        extents=extents, lod=lod, valid=valid,
        count=torch.tensor(1, dtype=torch.int32, device=device))


def select_all_surfaces(settings: TerrainSettings, camera_pos: torch.Tensor,
                        frustum_planes: torch.Tensor,
                        lod_ranges: torch.Tensor) -> SelectedInstances:
    """Selection over the (world/surface)^2 grid of quadtrees
    (TerrainPass.cpp:97-110), merged into one instance array: each
    surface's rows cut to ``max_instances``, then the merged rows. CUDA
    tensors launch ``vrt_select`` once for all the surfaces, CPU tensors
    run ``select_all_surfaces_plain``."""
    if camera_pos.device.type == "cpu":
        return select_all_surfaces_plain(settings, camera_pos,
                                         frustum_planes, lod_ranges)
    return select_cuda(settings, camera_pos, frustum_planes, lod_ranges,
                       per_side=settings.num_surfaces_per_side)[0]


def select_all_surfaces_plain(settings: TerrainSettings,
                              camera_pos: torch.Tensor,
                              frustum_planes: torch.Tensor,
                              lod_ranges: torch.Tensor) -> SelectedInstances:
    """``select_all_surfaces`` as a sweep of tensor operations a surface
    (``select_nodes_plain``), on any device."""
    nps = settings.num_surfaces_per_side
    if nps == 1:
        return select_nodes_plain(settings, camera_pos, frustum_planes,
                                  lod_ranges)[0]
    results = []
    for i in range(nps * nps):
        x = (-0.5 * (nps - 1) + i % nps) * settings.surface_size
        z = (-0.5 * (nps - 1) + i // nps) * settings.surface_size
        loc = torch.tensor([x, 0.0, z], dtype=torch.float32,
                           device=camera_pos.device)
        results.append(select_nodes_plain(settings, camera_pos,
                                          frustum_planes, lod_ranges,
                                          surface_location=loc)[0])
    cap = settings.max_instances
    valid = torch.cat([r.valid for r in results])
    count = sum(r.count for r in results)
    position, extents, lod = _compact(
        valid, cap, torch.cat([r.position for r in results]),
        torch.cat([r.extents for r in results]),
        torch.cat([r.lod for r in results]))
    out_valid = torch.arange(cap, device=valid.device) < torch.clamp(count, max=cap)
    return SelectedInstances(position, extents, lod, out_valid, count)


MAX_SELECT_THREADS = 1024   # vrt_select's one block: a thread a window node


def _check_select_input(name: str, x: torch.Tensor, shape: tuple,
                        device: torch.device) -> torch.Tensor:
    if tuple(x.shape) != shape:
        raise ValueError(f"select_cuda: {name} has shape {tuple(x.shape)}, "
                         f"needs {shape}")
    if x.dtype != torch.float32:
        raise ValueError(f"select_cuda: {name} is {x.dtype}, needs "
                         f"torch.float32")
    if x.device != device:
        raise ValueError(f"select_cuda: {name} is on {x.device}, the camera "
                         f"on {device}")
    return x.contiguous()


def select_cuda(settings: TerrainSettings, camera_pos: torch.Tensor,
                frustum_planes: torch.Tensor, lod_ranges: torch.Tensor,
                per_side: int = 1
                ) -> tuple[SelectedInstances, SelectionDebug]:
    """One launch of the kernel ``vrt_select`` on the camera's CUDA device:
    the selection of the ``per_side`` x ``per_side`` surfaces around the
    origin (``select_all_surfaces``' grid) and the first surface's debug
    masks, bit-identical to ``select_nodes_plain`` /
    ``select_all_surfaces_plain``. Reads no value on the host. Inputs:
    ``camera_pos`` (3,), ``frustum_planes`` (6, 4) and ``lod_ranges``
    (max_lods,), float32 on one CUDA device."""
    w = settings.select_window
    if w * w > MAX_SELECT_THREADS:
        raise ValueError(
            f"select_cuda: select_window {w} needs {w * w} threads, one a "
            f"node of the {w}x{w} window; the kernel's block takes at most "
            f"{MAX_SELECT_THREADS}")
    dev = camera_pos.device
    cam = _check_select_input("camera_pos", camera_pos, (3,), dev)
    planes = _check_select_input("frustum_planes", frustum_planes, (6, 4), dev)
    ranges = _check_select_input("lod_ranges", lod_ranges,
                                 (settings.max_lods,), dev)
    if dev.type != "cuda":
        raise ValueError(f"select_cuda: the kernel runs on a CUDA device; "
                         f"the inputs are on {dev}")
    cap = settings.max_instances
    levels = settings.num_lods + 1
    position = torch.empty((cap, 3), dtype=torch.float32, device=dev)
    extents = torch.empty((cap, 3), dtype=torch.float32, device=dev)
    lod = torch.empty((cap,), dtype=torch.int32, device=dev)
    valid = torch.empty((cap,), dtype=torch.bool, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    selected = torch.empty((levels, w, w), dtype=torch.bool, device=dev)
    culled = torch.empty((levels, w, w), dtype=torch.bool, device=dev)
    origin = torch.empty((levels, 2), dtype=torch.int32, device=dev)
    _build.launch("vrt_select", dev, cam.data_ptr(), planes.data_ptr(),
                  ranges.data_ptr(), per_side, settings.surface_size, settings.num_lods, w, cap,
                  position.data_ptr(), extents.data_ptr(), lod.data_ptr(),
                  valid.data_ptr(), count.data_ptr(), selected.data_ptr(),
                  culled.data_ptr(), origin.data_ptr())
    select_cuda.launches += 1
    return (SelectedInstances(position, extents, lod, valid, count),
            SelectionDebug(selected, culled, origin))


select_cuda.launches = 0
