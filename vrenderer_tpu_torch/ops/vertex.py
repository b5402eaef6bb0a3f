"""Terrain vertex stage: instance transform, CDLOD morph, heightmap
displacement and per-vertex shading attributes (terrain_vs.hlsl), ported
from ``vrenderer_tpu.ops.vertex``.

Like the JAX package, every channel is sampled on the instance's regular
lattice and blended toward the even-floor vertex by morphK
(vertex.py:13-23 of the JAX package), not sampled at the morphed position
as the HLSL shader does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vrenderer_tpu_torch.config import TerrainSettings
from vrenderer_tpu_torch.ops import texture
from vrenderer_tpu_torch.terrain.quadtree import SelectedInstances
from vrenderer_tpu_torch.utils import math3d

# attribute channel layout
ATTR_ALBEDO = slice(0, 3)
ATTR_NORMAL = slice(3, 6)
ATTR_SHADOW = 6
ATTR_HEIGHT = 7
NUM_ATTRS = 8

# PS normal-tap offset in uv units (terrain_ps.hlsl:59)
NORMAL_UV_OFFSET = 0.1


class VertexOutput(NamedTuple):
    world: torch.Tensor  # (I, S, S, 3) morphed world positions
    attrs: torch.Tensor  # (I, S, S, NUM_ATTRS)


class VertexGeom(NamedTuple):
    """Geometry phase: morphed positions plus the lattice state the
    attribute phase needs."""

    world: torch.Tensor   # (I, S, S, 3)
    u: torch.Tensor       # (I, S)
    v: torch.Tensor       # (I, S)
    k: torch.Tensor       # (I, S, S) morph factor
    h_m: torch.Tensor     # (I, S, S) morphed height01


def shifted_field(tex: torch.Tensor, du: float, dv: float) -> torch.Tensor:
    """``tex`` resampled at (u+du, v+dv) on its own lattice, clamp
    addressing, as a 2-tap blend per axis."""
    H, W = tex.shape[:2]

    def shift_axis(t, d, size, dim):
        s = torch.tensor(d * (size - 1), dtype=torch.float32, device=t.device)
        i0 = int(torch.floor(s))
        f = s - i0
        idx = torch.arange(size, device=t.device)
        a = torch.index_select(t, dim, torch.clamp(idx + i0, 0, size - 1))
        b = torch.index_select(t, dim, torch.clamp(idx + i0 + 1, 0, size - 1))
        return a * (1.0 - f) + b * f

    out = tex
    if du != 0.0:
        out = shift_axis(out, du, W, 1)
    if dv != 0.0:
        out = shift_axis(out, dv, H, 0)
    return out


def normal_fields(heightmap: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) unnormalized normal field, n = (-hDx, 2*offset, -hDy) with
    central-difference taps at uv +- 0.1 (terrain_ps.hlsl:59-63)."""
    o = NORMAL_UV_OFFSET
    hdx = shifted_field(heightmap, +o, 0.0) - shifted_field(heightmap, -o, 0.0)
    hdy = shifted_field(heightmap, 0.0, +o) - shifted_field(heightmap, 0.0, -o)
    up = torch.full_like(heightmap, 2.0 * o)
    return torch.stack([-hdx, up, -hdy], dim=-1)


def morph_k(dist: torch.Tensor, grid_extents: torch.Tensor,
            lod_ranges: torch.Tensor) -> torch.Tensor:
    """computeMorphK (terrain_vs.hlsl:16-25)."""
    max_lods = lod_ranges.shape[0]
    lod = torch.clamp(
        torch.floor(torch.log2(torch.clamp(grid_extents, min=1e-20))),
        0, max_lods - 1,
    ).long()
    rng = lod_ranges[lod]
    start = rng * 0.85
    return torch.clamp((dist - start) / (rng - start), 0.0, 1.0)


def _even_floor(x: torch.Tensor) -> torch.Tensor:
    """Value at the even-floor lattice vertex along both grid axes (dims 1
    and 2)."""
    idx = (torch.arange(x.shape[1], device=x.device) // 2) * 2
    return torch.index_select(torch.index_select(x, 1, idx), 2, idx)


def _blend_even(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Blend a channel toward the even-floor vertex value by morphK."""
    qe = _even_floor(q)
    kk = k if q.ndim == 3 else k[..., None]
    return q * (1.0 - kk) + qe * kk


def vertex_geometry(settings: TerrainSettings, instances: SelectedInstances,
                    camera_pos: torch.Tensor, heightmap: torch.Tensor,
                    max_height: torch.Tensor, lod_ranges: torch.Tensor
                    ) -> VertexGeom:
    """Morph + displacement (positions exactly as vertex_stage computes
    them); heights sampled in full float32."""
    S = settings.verts_per_side
    world = float(settings.world_size)
    gs = float(settings.grid_size)
    I = instances.position.shape[0]

    g = math3d.linspace(-1.0, 1.0, S, device=heightmap.device)
    ux = instances.position[:, 0:1] + instances.extents[:, 0:1] * g[None, :]
    uz = instances.position[:, 2:3] + instances.extents[:, 2:3] * g[None, :]
    u = texture.world_to_uv(ux, world)
    v = texture.world_to_uv(uz, world)
    h = texture.sample_separable(heightmap, u, v, mode=settings.uv_mode)

    # morph factor from the UNmorphed position (terrain_vs.hlsl:46)
    wx = ux[:, None, :].expand(I, S, S)
    wz = uz[:, :, None].expand(I, S, S)
    dist = math3d.sqrt_rn((wx - camera_pos[0]) ** 2
                          + (wz - camera_pos[2]) ** 2)
    grid_extents = 2.0 * instances.extents[:, 0]
    k = morph_k(dist, grid_extents[:, None, None], lod_ranges)

    # morphVertex: xz shift toward the even-floor vertex (terrain_vs.hlsl:10-14)
    grid01 = (g + 1.0) * 0.5
    frac_part = (grid01 * gs * 0.5 - torch.floor(grid01 * gs * 0.5)) * 2.0 / gs
    ge = grid_extents[:, None, None]
    x_m = wx - frac_part[None, None, :] * ge * k
    z_m = wz - frac_part[None, :, None] * ge * k

    h_m = _blend_even(h, k)
    y = h_m * max_height
    return VertexGeom(world=torch.stack([x_m, y, z_m], dim=-1), u=u, v=v,
                      k=k, h_m=h_m)


def vertex_attrs(settings: TerrainSettings, geom: VertexGeom,
                 albedo: torch.Tensor, shadow_field: torch.Tensor,
                 nrm_field: torch.Tensor) -> torch.Tensor:
    """Attribute phase: albedo, normal field and shadow sampled as one
    7-channel texture on the geometry phase's lattice, then morphed."""
    vis_tex = torch.cat([albedo, nrm_field, shadow_field[..., None]], dim=-1)
    vis_s = texture.sample_separable(vis_tex, geom.u, geom.v,
                                     mode=settings.uv_mode)
    alb_m = _blend_even(vis_s[..., 0:3], geom.k)
    nrm_m = _blend_even(vis_s[..., 3:6], geom.k)
    shad_m = _blend_even(vis_s[..., 6], geom.k)
    # the squares summed x, y, z in order, as the CPU's sum does; the
    # card's reduction adds them in another order
    sq = nrm_m * nrm_m
    nrm_m = nrm_m / math3d.sqrt_rn(
        (sq[..., 0:1] + sq[..., 1:2]) + sq[..., 2:3] + 1e-20)
    return torch.cat(
        [alb_m, nrm_m, shad_m[..., None], geom.h_m[..., None]], dim=-1
    )


def vertex_stage(settings: TerrainSettings, instances: SelectedInstances,
                 camera_pos: torch.Tensor, heightmap: torch.Tensor,
                 albedo: torch.Tensor, shadow_field: torch.Tensor,
                 max_height: torch.Tensor, lod_ranges: torch.Tensor,
                 nrm_field: torch.Tensor | None = None) -> VertexOutput:
    """vertex_geometry + vertex_attrs for all instances at once.
    ``nrm_field``: normal_fields(heightmap), static per heightmap."""
    if nrm_field is None:
        nrm_field = normal_fields(heightmap)
    geom = vertex_geometry(settings, instances, camera_pos, heightmap,
                           max_height, lod_ranges)
    attrs = vertex_attrs(settings, geom, albedo, shadow_field, nrm_field)
    return VertexOutput(world=geom.world, attrs=attrs)


def vertex_stage_exact(settings: TerrainSettings, instances: SelectedInstances,
                       camera_pos: torch.Tensor, heightmap: torch.Tensor,
                       max_height: torch.Tensor, lod_ranges: torch.Tensor
                       ) -> torch.Tensor:
    """Test oracle, the literal terrain_vs.hlsl:35-62: morph first, then
    sample the heightmap at the morphed position with the per-point
    bilinear sampler. Returns world positions (I, S, S, 3)."""
    S = settings.verts_per_side
    world = float(settings.world_size)
    gs = float(settings.grid_size)
    I = instances.position.shape[0]

    g = math3d.linspace(-1.0, 1.0, S, device=heightmap.device)
    ux = instances.position[:, 0:1] + instances.extents[:, 0:1] * g[None, :]
    uz = instances.position[:, 2:3] + instances.extents[:, 2:3] * g[None, :]
    wx = ux[:, None, :].expand(I, S, S)
    wz = uz[:, :, None].expand(I, S, S)

    dist = math3d.sqrt_rn((wx - camera_pos[0]) ** 2
                          + (wz - camera_pos[2]) ** 2)
    grid_extents = 2.0 * instances.extents[:, 0]
    k = morph_k(dist, grid_extents[:, None, None], lod_ranges)

    grid01 = (g + 1.0) * 0.5
    frac_part = (grid01 * gs * 0.5 - torch.floor(grid01 * gs * 0.5)) * 2.0 / gs
    ge = grid_extents[:, None, None]
    x_m = wx - frac_part[None, None, :] * ge * k
    z_m = wz - frac_part[None, :, None] * ge * k

    u = texture.world_to_uv(x_m, world)
    v = texture.world_to_uv(z_m, world)
    y = texture.sample_points(heightmap, u, v,
                              mode=settings.uv_mode) * max_height
    return torch.stack([x_m, y, z_m], dim=-1)
