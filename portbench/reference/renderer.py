"""The frame, plainly: view constants, scene refresh, the shadow phase,
LOD selection, the vertex stage, triangle setup, binning, the plain
rasterizer, deferred lighting, eye adaptation, tonemap, sky and the sRGB
encode (Renderer.cpp:321-446), in either shadow mode:

* "horizon": the height-field march over terrain and the scene's mesh
  tops, once per sun (``horizon_prepass``);
* "map": a light-view selection, its geometry and a depth-only raster
  every frame, comparison-filtered into the terrain's shadow field and
  the mesh receivers' factors; the main pass reuses the light pass's
  geometry, masked to the main frustum's nodes.

A frozen copy of ``vrenderer_tpu_torch.renderer``'s frame path as it stood
when the benchmark was written, reduced to what the benchmark's
configurations run (no screen bands, lock-view, prepass caches, dense
oracle, two-phase or wireframe raster), with the plain rasterizer in
place of the kernels. ``counts`` runs the frame only as far as its work
lists, for the counts of every camera of a loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from portbench.reference import (
    lighting, precision, quadtree, raster, raster_plain, shadow, texture,
    vertex,
)
from portbench.reference import grid as gridmod
from portbench.reference import math3d
from portbench.reference import mesh as meshmod
from portbench.reference.camera import Camera, make_view_constants
from portbench.reference.config import FrameConfig


class FrameParams(NamedTuple):
    """Per-frame knobs as tensors (Renderer.h:34-48)."""

    max_height: torch.Tensor
    ambient_intensity: torch.Tensor
    light_direction: torch.Tensor    # (3,)
    light_irradiance: torch.Tensor
    light_color: torch.Tensor        # (3,)
    exposure: torch.Tensor


class Frame(NamedTuple):
    ldr: torch.Tensor            # (H, W, 3) sRGB-encoded in [0, 1]
    hdr: torch.Tensor            # (H, W, 3) linear
    depth: torch.Tensor          # (H, W) ndc z, background 1
    prim_id: torch.Tensor        # (H, W) int32, -1 = background
    adapted_lum: torch.Tensor    # () the adaptation carry after the frame
    counts: "Counts"


class Counts(NamedTuple):
    """A frame's selection and work-list counts, Python ints. ``selected``
    is the raw selection count (map mode: the light selection's, whose
    geometry the main pass reuses); ``work_instances`` and
    ``light_work_instances`` count the distinct instances the main and
    light work lists hold, whose triangle rows a raster reads."""

    selected: int
    work_items: int
    work_instances: int
    light_work_items: int
    light_work_instances: int
    overflow_mask: int


class _ShadowInputs(NamedTuple):
    field: torch.Tensor                  # (H, W) terrain shadow factors
    mesh_fn: Optional[Callable]          # scene verts (B, V, 3) -> (B, V)
    scene_wa: Optional[tuple]            # scene blocks (world, attrs)
    instances: Optional[quadtree.SelectedInstances]
    geom: Optional[vertex.VertexGeom]
    light_work: Optional[raster_plain.WorkList]
    light_count: Optional[torch.Tensor]


def _distinct_items(work: raster_plain.WorkList) -> int:
    inst = work.items[:, 0]
    return int(torch.unique(inst[inst >= 0]).numel())


class Renderer:
    """The configuration's static state on ``device``: heightmap, albedo,
    normal field, patch grid and the scene's blocks."""

    def __init__(self, config: FrameConfig, heightmap: torch.Tensor,
                 albedo: torch.Tensor, max_work: int, max_active: int,
                 scene, device):
        if config.shadow_mode not in ("horizon", "map"):
            raise ValueError(f"unknown shadow_mode {config.shadow_mode!r}")
        self.device = torch.device(device)
        self.config = config
        self.heightmap = heightmap.to(self.device, torch.float32)
        self.albedo = albedo.to(self.device, torch.float32)
        self.max_work = max_work
        self.max_active = min(max_active, config.terrain.max_instances)
        self._nrm_field = vertex.normal_fields(self.heightmap)
        _, self.tri_indices = gridmod.make_grid(config.terrain.grid_size,
                                                device=self.device)
        self._horizon = None
        self._prepare_scene(scene)

    def _prepare_scene(self, scene):
        """Chunk the scene's meshes into object-space raster blocks."""
        dev = self.device
        tpb = self.config.terrain.tris_per_instance
        max_h = torch.tensor(400.0, dtype=torch.float32, device=dev)
        objs, nrms, cols, block_inst = [], [], [], []
        tops, top_inst, nreal = [], [], []
        for k, inst in enumerate(scene.instances):
            m = meshmod.Mesh(*(t.to(dev) for t in inst.mesh))
            w, a, tri_idx, _ = meshmod.mesh_to_blocks(m, tpb, max_h)
            objs.append(w)
            cols.append(a[..., 0:3])
            nrms.append(a[..., 3:6])
            block_inst += [k] * w.shape[0]
            tp = m.positions[m.tris.reshape(-1)]
            tops.append(tp)
            top_inst += [k] * tp.shape[0]
            nb = -(-m.num_tris // tpb)
            nreal += [min(tpb, m.num_tris - j * tpb) for j in range(nb)]
        self._scene_obj = torch.cat(objs)
        self._scene_obj_nrm = torch.cat(nrms)
        self._scene_col = torch.cat(cols)
        self._scene_block_inst = torch.tensor(block_inst, device=dev)
        self._scene_tri_idx = tri_idx
        self._scene_block_nreal = nreal
        self.scene_transforms = torch.stack(
            [i.transform.to(dev, torch.float32) for i in scene.instances])
        tot = torch.cat(tops)
        pad = (-(tot.shape[0] // 3)) % 64     # degenerate, culled
        self._scene_top_obj = torch.cat(
            [tot, torch.zeros((3 * pad, 3), dtype=torch.float32, device=dev)])
        self._scene_top_vert_inst = torch.tensor(top_inst + [0] * (3 * pad),
                                                 device=dev)

    def _scene_blocks(self, max_height):
        """Object-space scene blocks -> (world (B, V, 3), attrs (B, V, 8));
        normals by inv(L)^T."""
        M = self.scene_transforms[self._scene_block_inst]
        L = M[:, :3, :]
        world = (precision.einsum("bvc,bcd->bvd", self._scene_obj, L)
                 + M[:, 3][:, None, :])
        l_inv_t = torch.linalg.inv(L).transpose(1, 2)
        nrm = math3d.normalize(
            precision.einsum("bvc,bcd->bvd", self._scene_obj_nrm, l_inv_t))
        h01 = world[..., 1] / torch.clamp(max_height, min=1e-6)
        attrs = torch.cat([self._scene_col, nrm,
                           torch.ones_like(h01)[..., None], h01[..., None]],
                          dim=-1)
        return world, attrs

    def horizon_prepass(self, params: FrameParams):
        """(shadow field, shadow line) with the scene's meshes as
        occluders: once per sun, as the program caches it."""
        if self._horizon is None:
            world_size = float(self.config.terrain.world_size)
            M = self.scene_transforms[self._scene_top_vert_inst]
            top_world = (precision.einsum("vc,vcd->vd", self._scene_top_obj,
                                          M[:, :3, :]) + M[:, 3, :])[None]
            mesh_top = shadow.mesh_top_field(
                top_world, torch.ones((1,), dtype=torch.bool,
                                      device=self.device),
                world_size, self.heightmap.shape[0])
            self._horizon = shadow.horizon_shadow_field(
                self.heightmap, params.max_height, world_size,
                params.light_direction, occluder_h=mesh_top,
                with_shadow_line=True)
        return self._horizon

    def _mesh_receiver_factors(self, w, point_fn):
        """Shadow factors for scene-mesh vertices, computed on each block's
        real-vertex prefix and padded with 1.0 over the degenerate tail."""
        B, V = w.shape[0], w.shape[1]
        nreal = self._scene_block_nreal
        f = point_fn(torch.cat([w[b, :3 * nreal[b]] for b in range(B)]))
        outs, o = [], 0
        for b in range(B):
            n = 3 * nreal[b]
            outs.append(torch.cat([f[o:o + n], torch.ones(
                V - n, dtype=f.dtype, device=f.device)]))
            o += n
        return torch.stack(outs)

    def _clip_active(self, instances):
        """Prefix of the selection within the render budget."""
        ia = self.max_active
        if ia >= instances.valid.shape[0]:
            return instances
        return quadtree.SelectedInstances(
            position=instances.position[:ia], extents=instances.extents[:ia],
            lod=instances.lod[:ia], valid=instances.valid[:ia],
            count=instances.count)

    def _bin(self, parts, wtc, width: int, height: int):
        """Setup and binning of ``parts`` (world, attrs, valid, tri_idx):
        (TriSetup, instance count, work list)."""
        setups, bboxes, usables, dists = [], [], [], []
        for world, attrs, valid, tri_idx in parts:
            comp = raster.setup_components(world, attrs, valid, tri_idx, wtc,
                                           width, height)
            bbox, usable, dist = raster_plain.instance_bbox_components(
                comp, width, height, valid)
            setups.append(raster.stack_components(comp))
            bboxes.append(bbox)
            usables.append(usable)
            dists.append(dist)
        setup = raster.TriSetup(*(torch.cat(f) for f in zip(*setups)))
        work = raster_plain.build_work_list(
            torch.cat(bboxes), torch.cat(usables), width, height,
            tile=self.config.raster.tile_w, max_work=self.max_work,
            order_key=torch.cat(dists))
        return setup, sum(p[0].shape[0] for p in parts), work

    def _view(self, camera: Camera):
        cfg = self.config
        return make_view_constants(camera, cfg.width, cfg.height,
                                   cfg.vfov_degrees, cfg.z_near, cfg.z_far)

    def _view_rays(self, vc) -> torch.Tensor:
        """Unit world-space rays through every pixel, unprojected at the
        far plane."""
        cfg = self.config
        dev = self.device
        x = math3d.div_rn(torch.arange(cfg.width, dtype=torch.float32,
                                       device=dev) + 0.5, cfg.width)
        y = math3d.div_rn(torch.arange(cfg.height, dtype=torch.float32,
                                       device=dev) + 0.5, cfg.height)
        yy, xx = torch.meshgrid(1.0 - y * 2.0, x * 2.0 - 1.0, indexing="ij")
        one = torch.ones_like(xx)
        wpos = precision.matmul(torch.stack([xx, yy, one, one], -1),
                                vc["clip_to_world"])
        wpos = wpos[..., :3] / wpos[..., 3:4]
        return math3d.normalize_rn(wpos - vc["camera_pos"])

    # -- the shadow phase ---------------------------------------------------

    def _light_parts(self, params: FrameParams, camera_pos):
        """Light view, selection and vertex geometry."""
        cfg = self.config
        ts = cfg.terrain
        wtc, kx, kz, span_x, span_z = shadow.sun_shear_matrices(
            params.light_direction, float(ts.world_size), params.max_height,
            cfg.shadow_resolution)
        if cfg.shadow_select != "main" or cfg.shadow_eye_quant > 0.0 or (
                cfg.shadow_lod_bias):
            raise ValueError("the reference runs the light pass of "
                             "shadow_select='main' at full LOD only")
        ranges = ts.lod_ranges(self.device)
        instances = self._clip_active(quadtree.select_all_surfaces(
            ts, camera_pos, math3d.frustum_planes(wtc), ranges))
        geom = vertex.vertex_geometry(ts, instances, camera_pos,
                                      self.heightmap, params.max_height,
                                      ranges)

        def no_attrs(w):
            return w.new_zeros(w.shape[:-1] + (0,))

        s_world = self._scene_blocks(params.max_height)[0]
        parts = [(geom.world, no_attrs(geom.world), instances.valid,
                  self.tri_indices),
                 (s_world, no_attrs(s_world),
                  torch.ones((s_world.shape[0],), dtype=torch.bool,
                             device=self.device), self._scene_tri_idx)]
        return parts, wtc, (kx, kz, span_x, span_z), instances, geom

    def _shadow_inputs(self, vc, params: FrameParams, depth: bool = True
                       ) -> _ShadowInputs:
        """The shadow field, the mesh receivers' factor function and the
        scene blocks; in map mode also the light pass's selection,
        geometry and work list. ``depth=False`` stops the light pass at
        its work list (``counts``)."""
        cfg = self.config
        world_size = float(cfg.terrain.world_size)
        scene_wa = self._scene_blocks(params.max_height)
        if cfg.shadow_mode == "horizon":
            field, sline = self.horizon_prepass(params)

            def mesh_fn(w):
                def factors(pts):
                    u = texture.world_to_uv(pts[:, 0], world_size)
                    v = texture.world_to_uv(pts[:, 2], world_size)
                    s_at = texture.sample_points_matmul(sline, u, v)
                    return shadow.shadow_line_factor(pts[:, 1], s_at)

                return self._mesh_receiver_factors(w, factors)

            return _ShadowInputs(field, mesh_fn, scene_wa, None, None, None,
                                 None)

        res = cfg.shadow_resolution
        parts, wtc_l, shear, instances, geom = self._light_parts(
            params, vc["camera_pos"])
        setup, n_inst, work = self._bin(parts, wtc_l, res, res)
        if not depth:
            return _ShadowInputs(None, None, scene_wa, instances, geom, work,
                                 instances.count)
        depth_map = raster_plain.rasterize_depth_plain(
            raster_plain.pack_vis(setup, n_inst), work, res, res,
            tile=cfg.raster.tile_w)
        s0 = shadow.shear_map_heights(depth_map, depth_map < 2.0)
        field = shadow.factors_from_sun_shear_map(
            s0, self.heightmap, params.max_height, world_size, *shear,
            -params.light_direction[1])
        z_range = shadow._SHEAR_FAR - 1.0

        def mesh_fn(w):
            return self._mesh_receiver_factors(
                w, lambda pts: shadow.shadow_factors_from_map(
                    depth_map, wtc_l, z_range, pts))

        return _ShadowInputs(field, mesh_fn, scene_wa, instances, geom, work,
                             instances.count)

    def _main_members(self, light: quadtree.SelectedInstances, vc
                      ) -> quadtree.SelectedInstances:
        """The light selection restricted to the main frustum's nodes (both
        selections compute node positions by the same formula, so float
        equality is exact); slots keep the light selection's order."""
        ts = self.config.terrain
        inst_m = self._clip_active(quadtree.select_all_surfaces(
            ts, vc["camera_pos"], math3d.frustum_planes(vc["world_to_clip"]),
            ts.lod_ranges(self.device)))
        same = ((light.position[:, None, 0] == inst_m.position[None, :, 0])
                & (light.position[:, None, 2] == inst_m.position[None, :, 2])
                & (light.lod[:, None] == inst_m.lod[None, :])
                & inst_m.valid[None, :])
        return light._replace(valid=light.valid & same.any(dim=1))

    # -- the main pass ------------------------------------------------------

    def _main_parts(self, vc, params: FrameParams, sh: _ShadowInputs,
                    with_attrs: bool = True):
        """Select -> vertex: the main raster's parts and instances, terrain
        first, then the scene's blocks."""
        cfg = self.config
        ts = cfg.terrain
        dev = self.device
        if sh.instances is not None:
            instances = self._main_members(sh.instances, vc)
            geom = sh.geom
        else:
            lr = ts.lod_ranges(dev)
            instances = self._clip_active(quadtree.select_all_surfaces(
                ts, vc["camera_pos"], math3d.frustum_planes(
                    vc["world_to_clip"]), lr))
            geom = vertex.vertex_geometry(ts, instances, vc["camera_pos"],
                                          self.heightmap, params.max_height,
                                          lr)
        s_world, s_attrs = sh.scene_wa
        if with_attrs:
            attrs = vertex.vertex_attrs(ts, geom, self.albedo, sh.field,
                                        self._nrm_field)
            s_attrs = s_attrs.clone()
            s_attrs[..., vertex.ATTR_SHADOW] = sh.mesh_fn(s_world)
        else:
            attrs = geom.world.new_zeros(geom.world.shape[:-1] + (0,))
            s_attrs = s_world.new_zeros(s_world.shape[:-1] + (0,))
        parts = [(geom.world, attrs, instances.valid, self.tri_indices),
                 (s_world, s_attrs,
                  torch.ones((s_world.shape[0],), dtype=torch.bool,
                             device=dev), self._scene_tri_idx)]
        return parts, instances

    def _overflow(self, count, work, sh: _ShadowInputs) -> int:
        mask = int(int(work.num_items) > self.max_work)
        mask += 2 * int(int(count) > self.max_active)
        if sh.light_work is not None:
            mask += 4 * int(int(sh.light_work.num_items) > self.max_work
                            or int(sh.light_count) > self.max_active)
        return mask

    def _counts(self, instances, work, sh: _ShadowInputs) -> Counts:
        light = sh.light_work
        return Counts(
            selected=int(instances.count), work_items=int(work.num_items),
            work_instances=_distinct_items(work),
            light_work_items=0 if light is None else int(light.num_items),
            light_work_instances=0 if light is None
            else _distinct_items(light),
            overflow_mask=self._overflow(instances.count, work, sh))

    def counts(self, camera: Camera, params: FrameParams) -> Counts:
        """The frame's selection and work lists, without rasters or
        lighting."""
        cfg = self.config
        with torch.no_grad():
            vc = self._view(camera)
            sh = self._shadow_inputs(vc, params, depth=False)
            parts, instances = self._main_parts(vc, params, sh,
                                                with_attrs=False)
            _, _, work = self._bin(parts, vc["world_to_clip"], cfg.width,
                                   cfg.height)
            return self._counts(instances, work, sh)

    def frame(self, camera: Camera, params: FrameParams, adapted_lum,
              dt: float) -> Frame:
        """One adapting frame (the program's ``render_adaptive``) from the
        adaptation carry ``adapted_lum``."""
        cfg = self.config
        with torch.no_grad():
            vc = self._view(camera)
            sh = self._shadow_inputs(vc, params)
            parts, instances = self._main_parts(vc, params, sh)
            setup, n_inst, work = self._bin(parts, vc["world_to_clip"],
                                            cfg.width, cfg.height)
            z, prim_id, attrs = raster_plain.rasterize_plain(
                raster_plain.pack_setup(setup, n_inst), work, cfg.width,
                cfg.height, tile=cfg.raster.tile_w)
            covered = prim_id >= 0
            rays = self._view_rays(vc)
            # precision.store: float32, or bfloat16 for a control
            st = precision.store
            attrs, rays = st(attrs), st(rays)
            hdr = st(lighting.deferred_lighting(
                attrs[..., vertex.ATTR_ALBEDO], attrs[..., vertex.ATTR_NORMAL],
                torch.clamp(attrs[..., vertex.ATTR_SHADOW], 0.0, 1.0),
                covered, -rays, params.light_direction,
                params.light_irradiance, params.light_color,
                params.ambient_intensity))
            lum = torch.as_tensor(adapted_lum, dtype=torch.float32,
                                  device=self.device)
            sums = st(lighting.luminance_sums(hdr, covered))
            new_lum, scale = map(st, lighting.adapt_from_sums(
                sums, lum, float(dt)))
            ldr = st(lighting.tonemap(hdr, params.exposure * scale))
            sky = st(lighting.sky_color(rays, params.light_direction))
            ldr = st(lighting.srgb_encode(torch.where(covered[..., None], ldr,
                                                      sky)))
            depth = torch.where(covered, z, torch.ones_like(z))
            return Frame(ldr=ldr, hdr=hdr, depth=depth, prim_id=prim_id,
                         adapted_lum=new_lum,
                         counts=self._counts(instances, work, sh))
