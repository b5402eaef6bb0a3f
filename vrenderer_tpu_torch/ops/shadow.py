"""Terrain shadows, ported from ``vrenderer_tpu.ops.shadow``: both modes.

Horizon mode: ``horizon_shadow_field`` marches the height field toward the
sun in texture space with whole-texture fractional shifts, tracking the
maximum occluder slope; ``mesh_top_field`` renders scene meshes top-down
into an occluder height field through the CUDA rasterizer (its plain
version on the CPU).

Map mode (the reference's shadow map, Renderer.cpp:333-428): the renderer
rasters a depth-only light view through ``sun_shear_matrices`` (kernel B2,
``raster_cuda.rasterize_depth``), then samples it with 4-tap comparison
filtering: ``factors_from_sun_shear_map`` for the terrain lattice,
``shadow_factors_from_map`` for scene-mesh vertices. The JAX package
samples through float32 matrix products because gathers are slow on a
TPU; here both samplers gather, with the same texel weights and the same
rows-then-columns order, so their values agree with the products up to
the last bit (tests/test_torch_shadow_map.py states the bound).
"""

from __future__ import annotations

import torch

from vrenderer_tpu_torch.ops import texture
from vrenderer_tpu_torch.profiler import sync_copy
from vrenderer_tpu_torch.utils import math3d


def _shift2d(tex: torch.Tensor, du: torch.Tensor, dv: torch.Tensor
             ) -> torch.Tensor:
    """Shift a (H, W) field by a fractional (du, dv) in uv units, clamp
    addressing: two 2-tap axis blends."""
    H, W = tex.shape

    def axis_shift(t, d, size, dim):
        s = d * (size - 1)
        i0 = torch.floor(s).to(torch.int64)
        f = s - i0.to(torch.float32)
        idx = torch.arange(size, device=t.device)
        a = torch.index_select(t, dim, torch.clamp(idx + i0, 0, size - 1))
        b = torch.index_select(t, dim, torch.clamp(idx + i0 + 1, 0, size - 1))
        return a * (1.0 - f) + b * f

    return axis_shift(axis_shift(tex, du, W, 1), dv, H, 0)


def horizon_shadow_field(heightmap: torch.Tensor, max_height: torch.Tensor,
                         world_size: float, light_direction: torch.Tensor,
                         num_steps: int = 24, softness_slope: float = 0.03,
                         bias: float = 0.5,
                         occluder_h: torch.Tensor | None = None,
                         with_shadow_line: bool = False):
    """Shadow factor field (H, W) in [0, 1] (1 = lit): for each texel,
    march toward the sun with log-spaced steps from one texel to half the
    world, tracking the excess slope of occluders over the sun ray.

    ``occluder_h`` (world units) adds scene occluders to the march.
    ``with_shadow_line=True`` also returns the shadow-line height field
    S(x, z) = max_t(occ(x + t*sun_xz) - t*sun_slope), the lowest lit
    height at each texel (for ``shadow_line_factor``)."""
    Ht, Wt = heightmap.shape
    sun = math3d.normalize_rn(-light_direction)
    horiz = math3d.sqrt_rn(sun[0] ** 2 + sun[2] ** 2)
    sun_slope = sun[1] / torch.clamp(horiz, min=1e-6)
    dir_u = sun[0] / torch.clamp(horiz, min=1e-6)
    dir_v = sun[2] / torch.clamp(horiz, min=1e-6)

    h_world = heightmap * max_height
    occ_field = h_world
    if occluder_h is not None:
        occ_field = torch.maximum(occ_field, occluder_h)
    t0 = world_size / Wt
    t1 = world_size * 0.5
    ratio = (t1 / t0) ** (1.0 / (num_steps - 1))

    # not seeded with the surface itself: a receiver on the surface must
    # not count the surface as its own occluder
    excess = torch.full_like(heightmap, -1e9)
    sline = torch.full_like(heightmap, -1e9)
    t = t0
    for _ in range(num_steps):
        occ = _shift2d(occ_field, dir_u * (t / world_size),
                       dir_v * (t / world_size))
        excess = torch.maximum(
            excess, math3d.div_rn(occ - (h_world + bias), t) - sun_slope)
        if with_shadow_line:
            sline = torch.maximum(sline, occ - t * sun_slope)
        t *= ratio

    lit = 1.0 - torch.clamp(math3d.div_rn(excess, softness_slope) + 1.0,
                            0.0, 1.0)
    below = sun[1] <= 0.0          # sun at or below the horizon: all shadow
    lit = torch.where(below, torch.zeros_like(lit), lit)
    if with_shadow_line:
        sline = torch.where(below, torch.full_like(sline, 1e9), sline)
        return lit, sline
    return lit


def shadow_line_factor(y: torch.Tensor, sline: torch.Tensor,
                       softness_h: float = 2.0, bias: float = 0.5
                       ) -> torch.Tensor:
    """Shadow factor of receivers at height ``y`` against the shadow-line
    field, with a ``softness_h``-meter penumbra ramp."""
    excess = sline - (y + bias)
    return 1.0 - torch.clamp(math3d.div_rn(excess, softness_h) + 1.0, 0.0,
                             1.0)


# the overhead view of mesh_top_field: eye height and far plane
_TOP_EYE_H = 1.0e4
_TOP_FAR = 2.0e4


def mesh_top_inputs(world: torch.Tensor, valid: torch.Tensor,
                    world_size: float, resolution: int):
    """The overhead raster of ``mesh_top_field``: (packed triangles, work
    list of every supertile of the ``B`` instances), for the (res, res)
    target. ``world`` is (B, 3*T, 3), T triangles an instance as vertex
    triples."""
    from vrenderer_tpu_torch.ops import raster, raster_cuda

    dev = world.device
    # overhead view looking straight down with up = (0, 0, -1): pixel
    # columns follow +x and rows +z, so pixel (row, col) = texel (v, u)
    eye = torch.tensor([0.0, _TOP_EYE_H, 0.0], dtype=torch.float32,
                       device=dev)
    target = torch.zeros(3, dtype=torch.float32, device=dev)
    up = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float32, device=dev)
    w2v = math3d.look_at(eye, target, up)
    # pixel centres land on world_to_uv's texel lattice
    texel = world_size / (resolution - 1)
    ext = world_size * 0.5 + texel * 0.5
    proj = math3d.ortho_proj_d3d_style(-ext, ext, -ext, ext, 1.0, _TOP_FAR,
                                       device=dev)
    wtc = math3d.view_proj(w2v, proj)
    B, V = world.shape[0], world.shape[1]
    tpb = V // 3
    # zero attribute channels: the raster's plane layout carries 8
    attrs = torch.zeros((B, V, raster_cuda.NUM_ATTRS), dtype=torch.float32,
                        device=dev)
    idx = torch.arange(V, device=dev).reshape(tpb, 3)
    setup = raster.setup_triangles(world, attrs, valid, idx, wtc,
                                   resolution, resolution)
    return (raster_cuda.pack_setup(setup, B),
            raster_cuda.full_work_list(B, resolution, resolution,
                                       device=dev))


def mesh_top_field(world: torch.Tensor, valid: torch.Tensor,
                   world_size: float, resolution: int) -> torch.Tensor:
    """Top-down max-height field of scene geometry, (res, res) world units
    (-1e9 where empty), on the heightmap's texel lattice.

    ``world`` is (1, 3*T, 3): T triangles as vertex triples (a multiple of
    64, padded with degenerate triangles). They are rasterized from an
    overhead ortho view through ``raster_cuda.rasterize`` with a work list
    of every supertile of one instance (``mesh_top_inputs``); min z with
    ties to the lowest id, exactly what the JAX package's dense oracle
    computes."""
    from vrenderer_tpu_torch.ops import raster_cuda

    packed, work = mesh_top_inputs(world, valid, world_size, resolution)
    z, prim, _ = raster_cuda.rasterize(packed, work, resolution, resolution)
    height = _TOP_EYE_H - (1.0 + z * (_TOP_FAR - 1.0))
    return torch.where(prim >= 0, height, torch.full_like(height, -1e9))


# sheared light view constants: depth z01 maps linearly to world height
# as h = EYE_H - (1 + z * (FAR - 1))
_SHEAR_EYE_H = 1.0e4
_SHEAR_FAR = 2.0e4


def sun_shear_matrices(light_direction: torch.Tensor, world_size: float,
                       max_height: torch.Tensor, resolution: int,
                       k_max: float = 4.0):
    """World->clip of the sun-ray-aligned (sheared) light view: each point
    maps to the ground point (x + y*kx, z + y*kz) of its sun ray, depth is
    linear in height, so the map lattice lands on the world's xz lattice.
    The shear vector's length is clamped to ``k_max`` (low suns), keeping
    its direction. The map spans the world plus ``max_height * |k|`` per
    axis, pixel centres on the span's texel lattice. Returns (wtc (4, 4),
    kx, kz, span_x, span_z), spans in world metres. Computed on the host
    and moved to the light direction's device, as ``make_view_constants``
    does: the light selection culls against these planes."""
    dev = light_direction.device
    out = _sun_shear_matrices(
        sync_copy(light_direction.detach(), "cpu"), world_size,
        sync_copy(torch.as_tensor(max_height).detach(), "cpu"), resolution,
        k_max)
    return tuple(sync_copy(v, dev) for v in out)


def _sun_shear_matrices(light_direction, world_size, max_height, resolution,
                        k_max):
    dev = light_direction.device
    d = light_direction.to(torch.float32)
    d = d / torch.sqrt(torch.sum(d * d) + 1e-20)
    drop = torch.clamp(-d[1], min=1e-3)      # metres of fall per unit travel
    kx = d[0] / drop
    kz = d[2] / drop
    norm = torch.sqrt(kx * kx + kz * kz)
    scale = torch.clamp(k_max / torch.clamp(norm, min=1e-6), max=1.0)
    kx = kx * scale
    kz = kz * scale
    # row-vector shear: ground = (x + y*kx, z + y*kz), height untouched
    shear = torch.eye(4, dtype=torch.float32, device=dev)
    shear[1, 0] = kx
    shear[1, 2] = kz
    span_x = world_size + 2.0 * max_height * torch.abs(kx)
    span_z = world_size + 2.0 * max_height * torch.abs(kz)
    # overhead ortho (mesh_top_field's construction); columns follow +x
    # (sheared), rows +z
    eye = torch.tensor([0.0, _SHEAR_EYE_H, 0.0], dtype=torch.float32,
                       device=dev)
    up = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float32, device=dev)
    w2v = math3d.look_at(eye, torch.zeros(3, dtype=torch.float32, device=dev),
                         up)
    ext_x = span_x * 0.5 + span_x / (resolution - 1) * 0.5
    ext_z = span_z * 0.5 + span_z / (resolution - 1) * 0.5
    proj = math3d.ortho_proj_d3d_style(-ext_x, ext_x, -ext_z, ext_z, 1.0,
                                       _SHEAR_FAR)
    return shear @ math3d.view_proj(w2v, proj), kx, kz, span_x, span_z


def shear_map_heights(depth_map: torch.Tensor, covered: torch.Tensor
                      ) -> torch.Tensor:
    """Sheared-view depth map -> occluder heights S0 (world metres, -1e9
    where nothing covers): the highest occluder on the sun rays grounding
    at each texel."""
    h = _SHEAR_EYE_H - (1.0 + depth_map * (_SHEAR_FAR - 1.0))
    return torch.where(covered, h, torch.full_like(h, -1e9))


def factors_from_sun_shear_map(s0: torch.Tensor, heightmap: torch.Tensor,
                               max_height: torch.Tensor, world_size: float,
                               kx, kz, span_x, span_z, sun_up,
                               num_slabs: int = 17, bias: float = 2.0,
                               pcf_px: float = 1.0) -> torch.Tensor:
    """Terrain shadow factors (H, W) from the sheared map's occluder
    heights ``s0`` (R, R). A receiver at (x, h, z) grounds its sun ray at
    (x + h*kx, z + h*kz) and is lit where h + bias clears S0 there. For
    each of ``num_slabs`` heights the samples over the terrain lattice form
    a grid; each slab is sampled at 4 half-texel PCF taps (rows, then
    columns, by gather), compared, averaged, and every texel blends the two
    slabs bracketing its own height."""
    R = s0.shape[0]
    Ht, Wt = heightmap.shape
    dev = s0.device
    h_world = heightmap * max_height
    gx = math3d.linspace(-world_size / 2, world_size / 2, Wt, device=dev)
    gz = math3d.linspace(-world_size / 2, world_size / 2, Ht, device=dev)
    dh = math3d.div_rn(max_height, num_slabs - 1)
    tap = 0.5 * pcf_px / (R - 1)
    hk = torch.stack([dh * k for k in range(num_slabs)])[:, None]
    u = (gx + hk * kx) / span_x + 0.5                           # (K, Wt)
    v = (gz + hk * kz) / span_z + 0.5                           # (K, Ht)
    offs = sync_copy(torch.tensor([-tap, tap], dtype=torch.float32), dev)
    uo = u[:, None, :] + offs[None, :, None]                     # (K, 2, Wt)
    vo = v[:, None, :] + offs[None, :, None]                     # (K, 2, Ht)

    y0, y1, wy0, wy1 = texture.bilinear_taps(vo, R)
    rows = (s0[y0] * wy0[..., None] + s0[y1] * wy1[..., None])   # (K,2,Ht,R)
    x0, x1, wx0, wx1 = texture.bilinear_taps(uo, R)

    def cols(i):                          # (K, 2[dv], 2[du], Ht, Wt)
        idx = i[:, None, :, None, :].expand(-1, 2, -1, Ht, -1)
        return torch.gather(rows[:, :, None].expand(-1, -1, 2, -1, -1), 4,
                            idx)

    sk = (cols(x0) * wx0[:, None, :, None, :]
          + cols(x1) * wx1[:, None, :, None, :])
    lit_k = (h_world + bias >= sk).to(torch.float32).sum((1, 2)) * 0.25

    # per-texel hat blend between the two bracketing slabs
    t = torch.clamp(h_world / dh, 0.0, num_slabs - 1)
    kf = torch.arange(num_slabs, dtype=torch.float32, device=dev)[:, None,
                                                                   None]
    wk = torch.clamp(1.0 - torch.abs(t[None] - kf), min=0.0)
    lit = torch.sum(wk * lit_k, dim=0)
    return torch.where(sun_up > 0.0, lit, torch.zeros_like(lit))


def shadow_factors_from_map(depth_map: torch.Tensor, wtc: torch.Tensor,
                            z_range: float, points: torch.Tensor,
                            bias_m: float = 2.0, pcf_px: float = 1.0
                            ) -> torch.Tensor:
    """Shadow factors (N,) of world points (N, 3) (mesh-vertex receivers)
    by 4-tap comparison sampling of a light-view depth map: the PCF step of
    the reference's deferred lighting (Renderer.cpp:417-428). The JAX
    package's chunked (chunk, R) x (R, R) product per tap is a bilinear
    gather here."""
    R = depth_map.shape[0]
    ndc = math3d.transform_points_h(wtc, points)[:, :3]     # ortho: w == 1
    # pixel coords (y down) -> texel-lattice uv for the sampler
    px = (ndc[:, 0] + 1.0) * 0.5 * R - 0.5
    py = (1.0 - ndc[:, 1]) * 0.5 * R - 0.5
    d = ndc[:, 2] - bias_m / z_range
    last = torch.full((), R - 1, dtype=px.dtype, device=px.device)
    acc = torch.zeros_like(px)
    for tx, ty in ((-0.5, -0.5), (0.5, -0.5), (-0.5, 0.5), (0.5, 0.5)):
        u01 = math3d.div_rn(px + tx * pcf_px, last)
        v01 = math3d.div_rn(py + ty * pcf_px, last)
        md = texture.sample_points(depth_map, u01, v01)
        acc = acc + (md >= d).to(torch.float32)
    return acc / 4


def light_view_matrices(light_direction: torch.Tensor, world_size: float,
                        max_height: torch.Tensor, resolution: int
                        ) -> torch.Tensor:
    """Ortho world->clip for the sun covering the whole terrain: the
    reference's single cascade with maxShadowDistance = zRange =
    WORLD_SIZE (Renderer.cpp:345-348)."""
    dev = light_direction.device
    d = -light_direction.to(torch.float32)
    d = d / torch.sqrt(torch.sum(d * d) + 1e-20)
    eye = d * (world_size * 1.5)
    up = torch.where(torch.abs(d[1]) > 0.99,
                     torch.tensor([0.0, 0.0, 1.0], device=dev),
                     torch.tensor([0.0, 1.0, 0.0], device=dev))
    w2v = math3d.look_at(eye, torch.zeros(3, dtype=torch.float32, device=dev),
                         up)
    half = world_size * 0.75
    proj = math3d.ortho_proj_d3d_style(-half, half, -half, half, 0.1,
                                       world_size * 3.0, device=dev)
    return math3d.view_proj(w2v, proj)
