"""Frame orchestration: the PyTorch counterpart of
``vrenderer_tpu.renderer`` (vRenderer::Renderer::RecordCommand,
Renderer.cpp:321-446).

One frame runs, in order: view constants, scene refresh (scene blocks to
world space), the shadow phase, LOD selection, the vertex stage, triangle
setup, binning, the rasterizer (``ops/raster_cuda.rasterize``, or
``rasterize_two_phase`` under ``RasterSettings.two_phase`` without
wireframe; ``reverse_z`` and ``wireframe`` select its depth test and fill
mode), deferred lighting, tonemap, sky after tonemap, and sRGB encode.
Every tensor lives on ``Renderer.device``: the CUDA device unless the
caller passes another, where the rasterizers launch their CUDA kernels; on
the CPU they run their plain versions. ``raster_backend="xla"`` takes the
main and light rasters to the dense oracle ``ops/raster.rasterize_xla``
instead, as the JAX package's "xla" backend does.

The shadow phase has two modes (``FrameConfig.shadow_mode``):

* "horizon": the height-field march over terrain and scene-mesh tops
  (or a cached ``horizon_shadow_prepass``).
* "map", the reference's architecture (Renderer.cpp:333-428): light
  selection, vertex geometry, a depth-only raster of the sheared light
  view (``raster_cuda.rasterize_depth``, kernel B2), then comparison-
  filtered sampling into the terrain shadow field and the mesh receivers'
  factors (or a cached ``shadow_prepass``). When the light pass selects
  from the main eye at full LOD, the main pass reuses its selection and
  geometry, masked to the main frustum's nodes.

Eye adaptation (``render_adaptive``) and lock-view (``select``,
``render_locked``) compose with both modes and with a prepass;
``debug_selection`` returns the quadtree debug view's masks and
``reload_pipelines`` drops the cached prepasses. A frame renders whole or
as a horizontal screen band of the same projection (``_frame_impl(band=
(y0, band_h))``, what ``parallel/sharded.py`` runs on each device of a
mesh): geometry stays whole-frame, the setup is rebased to the band's
rows, and the raster and image-space passes run over the band alone.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from vrenderer_tpu_torch.camera import Camera, make_view_constants
from vrenderer_tpu_torch.config import FrameConfig, LightParams
from vrenderer_tpu_torch.ops import (
    lighting, raster, raster_cuda, shadow, texture, vertex,
)
from vrenderer_tpu_torch.profiler import counter, span, sync_copy
from vrenderer_tpu_torch.terrain import grid as gridmod
from vrenderer_tpu_torch.terrain import quadtree
from vrenderer_tpu_torch.utils import math3d

class FrameParams(NamedTuple):
    """Per-frame knobs as tensors (the EditorParams/light analog,
    Renderer.h:34-48, Renderer.cpp:135-142)."""

    max_height: torch.Tensor
    ambient_intensity: torch.Tensor
    light_direction: torch.Tensor    # (3,)
    light_irradiance: torch.Tensor
    light_color: torch.Tensor        # (3,)
    exposure: torch.Tensor
    render_terrain: torch.Tensor     # 0 skips terrain: sky-only frame
    debug_quadtree: torch.Tensor     # 1 tints pixels by instance id

    @staticmethod
    def default(light: LightParams = LightParams(), device=None
                ) -> "FrameParams":
        def t(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return FrameParams(
            max_height=t(400.0), ambient_intensity=t(0.2),
            light_direction=t(light.direction),
            light_irradiance=t(light.irradiance), light_color=t(light.color),
            exposure=t(1.0), render_terrain=t(1.0), debug_quadtree=t(0.0),
        )


class FrameOutput(NamedTuple):
    ldr: torch.Tensor            # (H, W, 3) sRGB-encoded in [0, 1]
    hdr: torch.Tensor            # (H, W, 3) linear
    depth: torch.Tensor          # (H, W) ndc z, background 1
    prim_id: torch.Tensor        # (H, W) int32, -1 = background
    num_instances: torch.Tensor  # () selected instances, capped
    num_work_items: torch.Tensor  # () raster work-list fill (JAX count)
    overflow: torch.Tensor       # () bool: output may miss geometry
    num_selected: torch.Tensor   # () raw selection count
    # bit 1: work list > max_work; bit 2: selection > max_active;
    # bit 4: the map-mode shadow pass's work list or selection
    overflow_mask: torch.Tensor


def overflow_message(out: FrameOutput, renderer: "Renderer") -> str:
    """Which capacity overflowed, with its numerator (call when
    ``out.overflow`` is set; the reference asserts, TerrainPass.cpp:238)."""
    mask = int(out.overflow_mask)
    parts = []
    if mask & 1:
        parts.append(f"raster work list overflowed (work items="
                     f"{int(out.num_work_items)} > max_work="
                     f"{renderer.max_work})")
    if mask & 2:
        parts.append(f"render budget overflowed (selected instances="
                     f"{int(out.num_selected)} > max_active="
                     f"{renderer.max_active})")
    if mask & 4:
        parts.append("shadow-pass work list or render budget overflowed "
                     "(light-view selection spans the whole world; raise "
                     "max_active/max_work)")
    msg = "; ".join(parts) if parts else "overflow flag set (unknown cause)"
    return msg + " — output may be missing geometry"


class _GBuffer(NamedTuple):
    """The first half of a frame (or of a screen band of one), up to the
    image that eye adaptation reads: what ``_finish_frame`` needs."""

    hdr: torch.Tensor            # (h, W, 3)
    covered: torch.Tensor        # (h, W) bool
    z: torch.Tensor              # (h, W)
    prim_id: torch.Tensor        # (h, W) int32
    rays: torch.Tensor           # (h, W, 3) unit view rays
    count: torch.Tensor          # () raw selection count
    n_work: torch.Tensor         # () work items
    shadow_overflow: torch.Tensor  # () int32


class _ShadowInputs(NamedTuple):
    """What the shadow phase hands the main pass."""

    field: torch.Tensor                  # (H, W) terrain shadow factors
    mesh_fn: Optional[Callable]          # scene verts (B, V, 3) -> (B, V)
    scene_wa: Optional[tuple]            # scene blocks (world, attrs)
    # map mode's shared light-pass geometry (None: the main pass selects)
    instances: Optional[quadtree.SelectedInstances]
    vout: Optional[vertex.VertexOutput]
    overflow: torch.Tensor               # () int32, shadow-pass overflow


class Renderer:
    """Owns the static config and assets on ``device`` (default: the CUDA
    device; a RuntimeError without one, so pass ``device="cpu"`` there).

    raster_backend: "pallas" (default), the port's hand-written CUDA
    kernels (their plain versions on the CPU), or "xla", the dense oracle
    ``raster.rasterize_xla`` for the main and light rasters, which counts
    no work items; the JAX package's names, so its call sites carry over.
    interpret: accepted for the JAX package's API; the port has no kernel
    interpreter, so ``interpret=True`` on a CUDA device raises rather than
    run the plain versions there.

    max_active: render budget, the number of selected instances that feed
    the vertex/setup/raster pipeline (selection runs at max_instances;
    frames selecting more set FrameOutput.overflow)."""

    def __init__(self, config: FrameConfig, heightmap: torch.Tensor,
                 albedo: torch.Tensor, light: LightParams = LightParams(),
                 raster_backend: str = "pallas", interpret: bool = False,
                 max_work: int = 2048, scene: Any = None,
                 max_active: Optional[int] = None, device=None):
        if config.shadow_mode not in ("horizon", "map"):
            raise ValueError(f"unknown shadow_mode {config.shadow_mode!r}")
        if raster_backend not in ("pallas", "xla"):
            raise ValueError(f"unknown raster_backend {raster_backend!r}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Renderer renders on the CUDA device by default and none "
                    "is available; pass device=\"cpu\" to render on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        if interpret and self.device.type == "cuda":
            raise ValueError(
                "interpret=True: the port has no kernel interpreter, and on "
                "the CUDA device it launches the kernels; render on "
                "device=\"cpu\" for their plain versions")
        self.raster_backend = raster_backend
        self.interpret = interpret
        self.config = config
        if heightmap is None:
            # missing texture: the reference binds black
            # (Renderer.cpp:58-63, TerrainPass.cpp:415-417)
            warnings.warn("heightmap missing; using black texture")
            heightmap = torch.zeros((2, 2), dtype=torch.float32)
        heightmap = heightmap.to(self.device, torch.float32)
        if albedo is None:
            albedo = torch.zeros(heightmap.shape + (3,), dtype=torch.float32)
        albedo = albedo.to(self.device, torch.float32)
        if albedo.shape[:2] != heightmap.shape:
            # the vertex stage samples albedo with the heightmap's lattice
            Ht, Wt = heightmap.shape
            albedo = texture.sample_separable(
                albedo, math3d.linspace(0.0, 1.0, Wt, device=self.device),
                math3d.linspace(0.0, 1.0, Ht, device=self.device))
        self.heightmap = heightmap
        self.albedo = albedo
        self.light = light
        self.max_work = max_work
        self.max_active = min(max_active or config.terrain.max_instances,
                              config.terrain.max_instances)
        self._nrm_field = vertex.normal_fields(heightmap)
        # made on the host once (ROADMAP C), for selection and the vertex
        # stage of every frame
        self.lod_ranges = config.terrain.lod_ranges(self.device)
        _, self.tri_indices = gridmod.make_grid(config.terrain.grid_size,
                                                device=self.device)
        self._horizon_prepass_cache = None
        self._shadow_prepass_cache = None
        # copies of this state on other devices (parallel/sharded.py)
        self._band_replicas = {}
        self._prepare_scene(scene)
        rs = config.raster
        if raster_backend == "pallas" and rs.two_phase and not rs.wireframe:
            slots = self.max_active + (0 if self._scene_obj is None
                                       else self._scene_obj.shape[0])
            if slots > raster_cuda.MAX_RESOLVE_INSTANCES:
                raise ValueError(
                    f"two_phase takes at most "
                    f"{raster_cuda.MAX_RESOLVE_INSTANCES} instance slots "
                    f"(raster_cuda.MAX_RESOLVE_INSTANCES); this renderer has "
                    f"{slots} (max_active {self.max_active} plus scene "
                    f"blocks): lower max_active or render with "
                    f"two_phase=False")

    def _prepare_scene(self, scene):
        """Chunk scene meshes into object-space raster blocks; per-instance
        transforms stay in ``scene_transforms`` (N, 4, 3) and are applied
        every frame by ``_scene_blocks`` (Scene Refresh,
        Renderer.cpp:204,328-331)."""
        self._scene_obj = None
        self.scene_transforms = None
        if scene is None or not scene.instances:
            return
        from vrenderer_tpu_torch.models import mesh as meshmod

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
            # compact triangle set for mesh_top_field: the raster pays per
            # triangle, and blocks pad each mesh to tris_per_instance
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

    def _scene_blocks(self, scene_xf, max_height):
        """Object-space scene blocks -> (world (B, V, 3), attrs (B, V, 8));
        normals by inv(L)^T."""
        M = scene_xf[self._scene_block_inst]
        L = M[:, :3, :]
        world = (torch.einsum("bvc,bcd->bvd", self._scene_obj, L)
                 + M[:, 3][:, None, :])
        with span("Sync"):              # inv checks its pivots on the host
            l_inv_t = torch.linalg.inv(L).transpose(1, 2)
        nrm = math3d.normalize(
            torch.einsum("bvc,bcd->bvd", self._scene_obj_nrm, l_inv_t))
        h01 = world[..., 1] / torch.clamp(max_height, min=1e-6)
        attrs = torch.cat([self._scene_col, nrm, torch.ones_like(h01)[..., None],
                           h01[..., None]], dim=-1)
        return world, attrs

    def _scene_top_world(self, scene_xf):
        """World-space compact scene triangles for mesh_top_field,
        (1, 3*Tc, 3)."""
        M = scene_xf[self._scene_top_vert_inst]
        world = (torch.einsum("vc,vcd->vd", self._scene_top_obj, M[:, :3, :])
                 + M[:, 3, :])
        return world[None]

    def _horizon_fields(self, params: FrameParams, scene_xf):
        """(shadow field, shadow line) with scene meshes as occluders."""
        world_size = float(self.config.terrain.world_size)
        top_world = self._scene_top_world(scene_xf)
        mesh_top = shadow.mesh_top_field(
            top_world, torch.ones((1,), dtype=torch.bool, device=self.device),
            world_size, self.heightmap.shape[0])
        return shadow.horizon_shadow_field(
            self.heightmap, params.max_height, world_size,
            params.light_direction, occluder_h=mesh_top,
            with_shadow_line=True)

    def horizon_shadow_prepass(self, params: Optional[FrameParams] = None):
        """(shadow_field, shadow_line) for ``render(..., shadow_prepass=)``.
        Depends on the sun, max height, scene transforms and heightmap,
        never on the camera."""
        if self.config.shadow_mode != "horizon":
            raise ValueError("the horizon prepass needs shadow_mode="
                             "'horizon'")
        if self._scene_obj is None:
            raise ValueError("the horizon prepass is for scenes with meshes")
        if params is None:
            params = FrameParams.default(self.light, self.device)
        return self._horizon_fields(params, self.scene_transforms)

    def cached_horizon_prepass(self, params: Optional[FrameParams] = None):
        """``horizon_shadow_prepass`` memoized on (sun, max height, scene
        transforms): drive loops call it every frame."""
        if params is None:
            params = FrameParams.default(self.light, self.device)
        key = tuple(sync_copy(t.detach(), "cpu").numpy().tobytes() for t in (
            params.light_direction, params.max_height, self.scene_transforms))
        cached = self._horizon_prepass_cache
        if cached is None or cached[0] != key:
            self._horizon_prepass_cache = (
                key, self.horizon_shadow_prepass(params))
        return self._horizon_prepass_cache[1]

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

    # -- passes ------------------------------------------------------------

    def _clip_active(self, instances):
        """Prefix of the selection within the render budget (selection packs
        valid nodes to the front)."""
        ia = self.max_active
        if ia >= instances.valid.shape[0]:
            return instances
        return quadtree.SelectedInstances(
            position=instances.position[:ia], extents=instances.extents[:ia],
            lod=instances.lod[:ia], valid=instances.valid[:ia],
            count=instances.count)

    def _bin(self, parts, wtc, width: int, height: int, band=None):
        """Setup and binning of ``parts`` (world, attrs, valid, tri_idx),
        instances in order: (``raster_cuda.PackedSetup``, work list).
        ``band=(y0, band_h)``: the instance bounds come from the
        whole-frame setup, then bounds and setup are rebased to the band's
        rows and the work list covers ``band_h`` rows."""
        cfg = self.config
        out_h = height if band is None else band[1]
        with span("Setup"):
            setup = raster_cuda.setup_packed(
                parts, wtc, width, height,
                None if band is None else float(band[0]))
        with span("Bin"):
            work = raster_cuda.build_work_list(
                setup.bbox, setup.usable, width, out_h,
                tile=cfg.raster.tile_w, max_work=self.max_work,
                order_key=setup.dist)
        return setup, work

    def _raster_parts(self, vc: Dict[str, torch.Tensor], params: FrameParams,
                      sh: _ShadowInputs, lock_instances=None):
        """Select -> vertex: the main raster's (world, attrs, valid,
        tri_idx) parts and the instances. Terrain instances take slots
        0..max_active-1 and scene blocks follow. Map mode's shared geometry
        skips select and vertex; ``lock_instances`` (lock-view) replaces
        the selection."""
        cfg = self.config
        ts = cfg.terrain
        dev = self.device
        wtc = vc["world_to_clip"]
        if sh.vout is not None:
            instances, vout = sh.instances, sh.vout
        else:
            with span("Select"):
                lr = self.lod_ranges
                if lock_instances is None:
                    lock_instances = quadtree.select_all_surfaces(
                        ts, vc["camera_pos"], math3d.frustum_planes(wtc), lr)
                instances = self._clip_active(lock_instances)
                counter("Slots", instances.valid.shape[0])
            with span("Vertex"):
                vout = vertex.vertex_stage(
                    ts, instances, vc["camera_pos"], self.heightmap,
                    self.albedo, sh.field, params.max_height, lr,
                    nrm_field=self._nrm_field)
        parts = [(vout.world, vout.attrs, instances.valid, self.tri_indices)]
        if sh.scene_wa is not None:
            s_world, s_attrs = sh.scene_wa
            if sh.mesh_fn is not None:
                with span("Vertex"):        # the meshes' shadow factors
                    s_attrs = s_attrs.clone()
                    s_attrs[..., vertex.ATTR_SHADOW] = sh.mesh_fn(s_world)
            parts.append((s_world, s_attrs,
                          torch.ones((s_world.shape[0],), dtype=torch.bool,
                                     device=dev), self._scene_tri_idx))
        return parts, instances

    def _raster_inputs(self, vc: Dict[str, torch.Tensor], params: FrameParams,
                       sh: _ShadowInputs, lock_instances=None, band=None):
        """Select -> vertex -> setup -> bin: (packed triangles, work list,
        instances), rebased to ``band`` if given."""
        cfg = self.config
        parts, instances = self._raster_parts(vc, params, sh, lock_instances)
        setup, work = self._bin(parts, vc["world_to_clip"], cfg.width,
                                cfg.height, band)
        return setup.tris, work, instances

    @staticmethod
    def _setup(parts, wtc, width: int, height: int) -> raster.TriSetup:
        """The dense oracle's input: the parts' setups, instances in
        order."""
        setups = [raster.setup_triangles(w, a, v, t, wtc, width, height)
                  for w, a, v, t in parts]
        return raster.TriSetup(*(torch.cat(f) for f in zip(*setups)))

    def _terrain_pass(self, vc, params, sh: _ShadowInputs,
                      lock_instances=None, band=None):
        """Raster products (z, prim_id, attrs, instances, work items) of
        the frame, or of the ``band=(y0, band_h)`` rows of it."""
        cfg = self.config
        rs = cfg.raster
        out_h = cfg.height if band is None else band[1]
        if self.raster_backend == "xla":
            # the JAX package's "xla" backend counts no work items
            parts, instances = self._raster_parts(vc, params, sh,
                                                  lock_instances)
            with span("Setup"):
                setup = self._setup(parts, vc["world_to_clip"], cfg.width,
                                    cfg.height)
                if band is not None:
                    setup = raster.shift_setup_y(setup, float(band[0]))
            with span("Raster"):
                z, prim_id, attrs = raster.rasterize_xla(
                    setup, cfg.width, out_h, reverse_z=rs.reverse_z,
                    wire_px=1.0 if rs.wireframe else 0.0)
            return (z, prim_id, attrs, instances,
                    torch.zeros((), dtype=torch.int64, device=self.device))
        packed, work, instances = self._raster_inputs(vc, params, sh,
                                                      lock_instances, band)
        with span("Raster"):
            if rs.two_phase and not rs.wireframe:
                z, prim_id, attrs = raster_cuda.rasterize_two_phase(
                    packed, work, cfg.width, out_h, tile=rs.tile_w,
                    sub_h=rs.subtile_h, win_w=rs.win_w,
                    reverse_z=rs.reverse_z)
            else:
                z, prim_id, attrs = raster_cuda.rasterize(
                    packed, work, cfg.width, out_h, tile=rs.tile_w,
                    reverse_z=rs.reverse_z,
                    wire_px=1.0 if rs.wireframe else 0.0)
        return z, prim_id, attrs, instances, work.num_items

    def _view_rays(self, vc: Dict[str, torch.Tensor], band=None
                   ) -> torch.Tensor:
        """Unit world-space rays through every pixel of the frame, or of
        its ``band=(y0, band_h)`` rows, unprojected at the far plane in
        full float32 (the JAX package runs this product at
        Precision.HIGHEST: bf16 gave NaN rays on hardware)."""
        cfg = self.config
        dev = self.device
        x = math3d.div_rn(torch.arange(cfg.width, dtype=torch.float32,
                                       device=dev) + 0.5, cfg.width)
        if band is None:
            y = math3d.div_rn(torch.arange(cfg.height, dtype=torch.float32,
                                           device=dev) + 0.5, cfg.height)
        else:
            y0, band_h = band
            y = math3d.div_rn(torch.arange(band_h, dtype=torch.float32,
                                           device=dev) + 0.5 + float(y0),
                              cfg.height)
        yy, xx = torch.meshgrid(1.0 - y * 2.0, x * 2.0 - 1.0, indexing="ij")
        one = torch.ones_like(xx)
        wpos = torch.stack([xx, yy, one, one], -1) @ vc["clip_to_world"]
        wpos = wpos[..., :3] / wpos[..., 3:4]
        return math3d.normalize_rn(wpos - vc["camera_pos"])

    # -- frame -------------------------------------------------------------

    def _shadow_inputs(self, vc: Dict[str, torch.Tensor], params: FrameParams,
                       scene_xf=None, shadow_prepass=None,
                       locked: bool = False) -> _ShadowInputs:
        """"Scene Refresh" and "Terrain Shadow": the shadow field, the mesh
        receivers' factor function and the scene blocks, in either mode.
        ``locked``: the main pass keeps a lock-view selection, so map mode
        shares no geometry with it."""
        world_size = float(self.config.terrain.world_size)
        if scene_xf is None:
            scene_xf = self.scene_transforms
        with span("Scene"):
            scene_wa = self._scene_wa(params, scene_xf)
        if self.config.shadow_mode == "map":
            return self._map_shadow_inputs(vc, params, scene_wa,
                                           shadow_prepass, locked)
        no_overflow = torch.zeros((), dtype=torch.int32, device=self.device)
        if scene_wa is None:
            field = shadow.horizon_shadow_field(
                self.heightmap, params.max_height, world_size,
                params.light_direction)
            return _ShadowInputs(field, None, None, None, None, no_overflow)

        # horizon march over terrain + mesh tops; meshes receive through
        # the shadow-line field
        if shadow_prepass is not None:
            field, sline = shadow_prepass
        else:
            field, sline = self._horizon_fields(params, scene_xf)

        def mesh_fn(w):
            def factors(pts):
                u = texture.world_to_uv(pts[:, 0], world_size)
                v = texture.world_to_uv(pts[:, 2], world_size)
                s_at = texture.sample_points_matmul(sline, u, v)
                return shadow.shadow_line_factor(pts[:, 1], s_at)

            return self._mesh_receiver_factors(w, factors)

        return _ShadowInputs(field, mesh_fn, scene_wa, None, None,
                             no_overflow)

    def _map_shadow_inputs(self, vc, params, scene_wa, shadow_prepass,
                           locked: bool = False) -> _ShadowInputs:
        """Map mode: the light pass (or its cached result), the terrain
        field and the mesh receivers' PCF factors. With the light pass
        selecting from the main eye at full LOD its selection is a superset
        of the main frustum's (culling only removes), so the main pass
        reuses its geometry and runs only the attribute phase, which needs
        this pass's shadow field. A lock-view frame keeps its own frozen
        selection, so nothing is shared there (``locked``)."""
        cfg = self.config
        share = False
        with span("Light pass"):
            if shadow_prepass is not None:
                # a cached whole-world map: the light raster ran outside the
                # frame, and the cache is only valid for selections that do
                # not track the camera exactly, where sharing does not apply
                depth_map, wtc_l, z_range, overflow, shear = shadow_prepass
            else:
                # a coarsened (light eye, lod bias) or snapped-eye selection
                # is other geometry: the main view must morph from the true
                # eye
                share = (not locked and cfg.shadow_select == "main"
                         and cfg.shadow_lod_bias == 0
                         and cfg.shadow_eye_quant == 0.0)
                out = self._light_depth_pass(params, vc["camera_pos"],
                                             scene_wa, return_geom=share)
                depth_map, wtc_l, z_range, overflow, shear = out[:5]
            field = self.shadow_field_from_map(depth_map, shear, params)
        instances = vout = None
        if share:
            with span("Select"):
                instances = self._main_members(out[5], vc)
                counter("Slots", instances.valid.shape[0])
            geom = out[6]
            with span("Vertex"):
                vout = vertex.VertexOutput(
                    world=geom.world, attrs=vertex.vertex_attrs(
                        cfg.terrain, geom, self.albedo, field,
                        self._nrm_field))
        mesh_fn = None
        if scene_wa is not None:
            def mesh_fn(w):
                return self._mesh_receiver_factors(
                    w, lambda pts: shadow.shadow_factors_from_map(
                        depth_map, wtc_l, z_range, pts))

        return _ShadowInputs(field, mesh_fn, scene_wa, instances, vout,
                             overflow)

    def _main_members(self, light: quadtree.SelectedInstances, vc
                      ) -> quadtree.SelectedInstances:
        """The light selection restricted to the main frustum's nodes.

        The whole-world extras would flood the main work list: the clipless
        setup gives every instance behind the camera a full-screen bbox
        (the JAX package measured 6295 work items against 2048 at the map
        bench config). So the main selection runs too, and light slot i
        stays valid iff its (x, z, lod) node is in it; both selections
        compute node positions by the same formula, so float equality is
        exact. Slots keep the light selection's order (prim ids follow
        it)."""
        ts = self.config.terrain
        inst_m = self._clip_active(quadtree.select_all_surfaces(
            ts, vc["camera_pos"], math3d.frustum_planes(vc["world_to_clip"]),
            self.lod_ranges))
        same = ((light.position[:, None, 0] == inst_m.position[None, :, 0])
                & (light.position[:, None, 2] == inst_m.position[None, :, 2])
                & (light.lod[:, None] == inst_m.lod[None, :])
                & inst_m.valid[None, :])
        return light._replace(valid=light.valid & same.any(dim=1))

    def _view(self, camera: Camera):
        cfg = self.config
        return make_view_constants(camera, cfg.width, cfg.height,
                                   cfg.vfov_degrees, cfg.z_near, cfg.z_far)

    def raster_inputs(self, camera: Camera,
                      params: Optional[FrameParams] = None,
                      shadow_prepass=None, band=None):
        """(packed triangles, work list) that ``render`` hands the
        rasterizer for this camera, or a frame rendered in screen bands
        for its ``band=(y0, band_h)``: for driving the kernel on its own.
        In map mode without a prepass this runs the light pass too."""
        if params is None:
            params = FrameParams.default(self.light, self.device)
        vc = self._view(camera)
        with torch.no_grad():
            packed, work, _ = self._raster_inputs(
                vc, params, self._shadow_inputs(vc, params, None,
                                                shadow_prepass), band=band)
        return packed, work

    def _frame_impl(self, camera: Camera, params: FrameParams,
                    lock_instances=None, adapt=None, band=None,
                    scene_xf=None, shadow_prepass=None):
        """The one frame path (Renderer.cpp:321-446), either shadow mode.
        ``lock_instances``: a frozen selection (lock-view) in place of the
        main selection. ``adapt=(adapted_lum, dt)``: eye adaptation scales
        the exposure, and the frame returns (FrameOutput, new adapted
        luminance). ``band=(y0, band_h)``: only the rows [y0, y0 + band_h)
        of the same frame (its adaptation then sees the band alone; the
        sharded path instead runs the two halves, ``_gbuffer`` and
        ``_finish_frame``, and adapts to the sum of the bands'
        statistics)."""
        g = self._gbuffer(camera, params, lock_instances, band, scene_xf,
                          shadow_prepass)
        with span("Shade"):
            exposure = params.exposure
            if adapt is not None:
                adapted_lum, dt = adapt
                new_adapted, scale = lighting.adapt_exposure(
                    g.hdr, g.covered, adapted_lum, dt)
                exposure = exposure * scale
            out = self._finish_frame(g, params, exposure)
        if adapt is not None:
            return out, new_adapted
        return out

    def _gbuffer(self, camera: Camera, params: FrameParams,
                 lock_instances=None, band=None, scene_xf=None,
                 shadow_prepass=None) -> _GBuffer:
        """The frame up to its HDR image: view, shadow phase, geometry and
        raster ("Terrain"), deferred lighting. With ``band`` the geometry
        and the shadow phase are still the whole frame's; the raster and
        the lighting cover the band's rows."""
        with span("View"):
            vc = self._view(camera)
        sh = self._shadow_inputs(vc, params, scene_xf, shadow_prepass,
                                 locked=lock_instances is not None)

        # "Terrain": geometry + visibility + interpolated G-buffer attrs
        z, prim_id, attrs, instances, n_work = self._terrain_pass(
            vc, params, sh, lock_instances, band)
        with span("Shade"):
            covered = (prim_id >= 0) & (params.render_terrain > 0.5)
            albedo = attrs[..., vertex.ATTR_ALBEDO]
            normal = attrs[..., vertex.ATTR_NORMAL]
            shadow_px = torch.clamp(attrs[..., vertex.ATTR_SHADOW], 0.0, 1.0)
            rays = self._view_rays(vc, band)

            # "Deferred Lighting" (Renderer.cpp:417-428)
            hdr = lighting.deferred_lighting(
                albedo, normal, shadow_px, covered, -rays,
                params.light_direction, params.light_irradiance,
                params.light_color, params.ambient_intensity)
        return _GBuffer(hdr=hdr, covered=covered, z=z, prim_id=prim_id,
                        rays=rays, count=instances.count, n_work=n_work,
                        shadow_overflow=sh.overflow)

    def _finish_frame(self, g: _GBuffer, params: FrameParams,
                      exposure: torch.Tensor) -> FrameOutput:
        """The frame from its HDR image on: "ToneMapping" at ``exposure``,
        then "Sky" after tonemap (Renderer.cpp:429-439), the debug overlay
        and the sRGB encode."""
        cfg = self.config
        covered, prim_id = g.covered, g.prim_id
        ldr_linear = lighting.tonemap(g.hdr, exposure)
        sky = lighting.sky_color(g.rays, params.light_direction)
        ldr_linear = torch.where(covered[..., None], ldr_linear, sky)

        # quadtree debug overlay: tint covered pixels by an instance hash
        # (Renderer.cpp:481-513)
        inst_px = torch.div(prim_id, cfg.terrain.tris_per_instance,
                            rounding_mode="floor").to(torch.float32)
        tint = torch.stack([
            0.5 + 0.5 * torch.sin(inst_px * 12.9898),
            0.5 + 0.5 * torch.sin(inst_px * 78.233 + 1.3),
            0.5 + 0.5 * torch.sin(inst_px * 37.719 + 2.6),
        ], dim=-1)
        dbg = params.debug_quadtree * covered[..., None].to(torch.float32)
        ldr_linear = ldr_linear * (1.0 - 0.5 * dbg) + tint * (0.5 * dbg)

        # "Blit": sRGB encode
        ldr = lighting.srgb_encode(ldr_linear)
        depth = torch.where(covered, g.z, torch.ones_like(g.z))
        count, n_work = g.count, g.n_work
        work_ovf = n_work > self.max_work
        sel_ovf = count > self.max_active
        shadow_ovf = g.shadow_overflow > 0
        return FrameOutput(
            ldr=ldr, hdr=g.hdr, depth=depth, prim_id=prim_id,
            num_instances=torch.clamp(count, max=cfg.terrain.max_instances),
            num_work_items=n_work,
            overflow=work_ovf | sel_ovf | shadow_ovf,
            num_selected=count,
            overflow_mask=(work_ovf.to(torch.int32)
                           + 2 * sel_ovf.to(torch.int32)
                           + 4 * shadow_ovf.to(torch.int32)),
        )

    def render(self, camera: Camera, params: Optional[FrameParams] = None,
               shadow_prepass=None) -> FrameOutput:
        """Render one frame. ``shadow_prepass``: in horizon mode the
        (shadow_field, shadow_line) pair of ``cached_horizon_prepass``, in
        map mode the tuple of ``cached_shadow_prepass``; frames with it are
        identical to frames without."""
        if params is None:
            params = FrameParams.default(self.light, self.device)
        with torch.no_grad():
            return self._frame_impl(camera, params,
                                    shadow_prepass=shadow_prepass)

    # -- map-mode shadow pass (the reference's "Terrain Shadow") ---------

    def shadow_field_from_map(self, depth_map, shear, params):
        """Terrain shadow factors from a sheared light-view depth map."""
        s0 = shadow.shear_map_heights(depth_map, depth_map < 2.0)
        return shadow.factors_from_sun_shear_map(
            s0, self.heightmap, params.max_height,
            float(self.config.terrain.world_size), *shear,
            -params.light_direction[1])

    def _light_select(self, params: FrameParams, wtc,
                      camera_pos: Optional[torch.Tensor] = None):
        """Light-view LOD selection, culled by the light frustum of ``wtc``:
        (instances, selection eye, LOD ranges). The eye is the main camera
        (default (0, max_height, 0)), snapped to the cell centres of
        ``shadow_eye_quant`` if set, or under ``shadow_select="light"`` the
        CSM proxy eye, the world centre backed off one WORLD_SIZE along the
        sun (Renderer.cpp:345-348). ``shadow_lod_bias`` halves the ranges
        per step."""
        cfg = self.config
        ts = cfg.terrain
        dev = self.device
        if camera_pos is None:
            camera_pos = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                                      device=dev) * params.max_height
        sel_eye = camera_pos
        if cfg.shadow_select == "main" and cfg.shadow_eye_quant > 0.0:
            q = torch.tensor(cfg.shadow_eye_quant, dtype=torch.float32,
                             device=dev)
            sel_eye = (torch.floor(sel_eye / q) + 0.5) * q
        sel_ranges = self.lod_ranges
        if cfg.shadow_select == "light":
            sel_eye = (-math3d.normalize_rn(params.light_direction)
                       * float(ts.world_size))
        if cfg.shadow_lod_bias:
            sel_ranges = sel_ranges * (0.5 ** cfg.shadow_lod_bias)
        instances = quadtree.select_all_surfaces(
            ts, sel_eye, math3d.frustum_planes(wtc), sel_ranges)
        return self._clip_active(instances), sel_eye, sel_ranges

    def _light_pass_inputs(self, params: FrameParams, camera_pos=None,
                           scene_wa=None):
        """Light view, selection, vertex geometry and binning of the light
        pass: (visibility rows, work list, world->clip, shear, instances,
        geometry). No attribute planes are set up: B2 reads none."""
        res = self.config.shadow_resolution
        parts, wtc, shear, instances, geom = self._light_parts(
            params, camera_pos, scene_wa)
        setup, work = self._bin(parts, wtc, res, res)
        return setup.tris.vis, work, wtc, shear, instances, geom

    def _light_parts(self, params: FrameParams, camera_pos=None,
                     scene_wa=None):
        """Light view, selection and vertex geometry: (the light raster's
        parts without attribute channels, world->clip, shear, instances,
        geometry)."""
        cfg = self.config
        ts = cfg.terrain
        wtc, kx, kz, span_x, span_z = shadow.sun_shear_matrices(
            params.light_direction, float(ts.world_size), params.max_height,
            cfg.shadow_resolution)
        with span("Select"):
            instances, sel_eye, sel_ranges = self._light_select(
                params, wtc, camera_pos)
            counter("Slots", instances.valid.shape[0])
        with span("Vertex"):
            geom = vertex.vertex_geometry(ts, instances, sel_eye,
                                          self.heightmap, params.max_height,
                                          sel_ranges)

        def no_attrs(w):
            return w.new_zeros(w.shape[:-1] + (0,))

        parts = [(geom.world, no_attrs(geom.world), instances.valid,
                  self.tri_indices)]
        if scene_wa is not None:
            s_world = scene_wa[0]
            parts.append((s_world, no_attrs(s_world),
                          torch.ones((s_world.shape[0],), dtype=torch.bool,
                                     device=self.device),
                          self._scene_tri_idx))
        return parts, wtc, (kx, kz, span_x, span_z), instances, geom

    def _light_depth_pass(self, params: FrameParams, camera_pos=None,
                          scene_wa=None, return_geom: bool = False):
        """Depth-only raster of terrain and scene meshes along the sun's
        rays (the reference's shadow phase, Renderer.cpp:354-379) in the
        sheared projection. Returns (depth (R, R) z01, world->clip, z range
        in metres, overflow (), (kx, kz, span_x, span_z)), and with
        ``return_geom`` also the selection and its vertex geometry. The
        overflow flag covers the light work list (> max_work) and the
        light selection (> max_active): truncating either would drop
        occluders. The "xla" backend has no work list, so its flag covers
        the selection only, as in the JAX package."""
        res = self.config.shadow_resolution
        if self.raster_backend == "xla":
            parts, wtc, shear, instances, geom = self._light_parts(
                params, camera_pos, scene_wa)
            with span("Setup"):
                setup = self._setup(parts, wtc, res, res)
            with span("Raster"):
                z = raster.rasterize_xla(setup, res, res)[0]
            overflow = (instances.count > self.max_active).to(torch.int32)
        else:
            vis, work, wtc, shear, instances, geom = self._light_pass_inputs(
                params, camera_pos, scene_wa)
            with span("Raster"):
                z = raster_cuda.rasterize_depth(
                    vis, work, res, res, tile=self.config.raster.tile_w)
            overflow = ((work.num_items > self.max_work)
                        | (instances.count > self.max_active)).to(torch.int32)
        out = (z, wtc, shadow._SHEAR_FAR - 1.0, overflow, shear)
        if return_geom:
            return out + (instances, geom)
        return out

    def light_raster_inputs(self, camera: Optional[Camera] = None,
                            params: Optional[FrameParams] = None):
        """(visibility rows, work list) that ``render`` hands the depth-only
        rasterizer for this camera, or without one those of
        ``render_shadow_depth`` (the default eye): for driving kernel B2
        on its own."""
        if params is None:
            params = FrameParams.default(self.light, self.device)
        with torch.no_grad():
            vis, work, *_ = self._light_pass_inputs(
                params, None if camera is None else camera.eye,
                self._scene_wa(params))
        return vis, work

    def _scene_wa(self, params: FrameParams, scene_xf=None):
        """"Scene Refresh" (Renderer.cpp:328-331): the scene blocks in world
        space, or None without a scene."""
        if self._scene_obj is None:
            return None
        if scene_xf is None:
            scene_xf = self.scene_transforms
        return self._scene_blocks(scene_xf, params.max_height)

    def shadow_prepass(self, params: Optional[FrameParams] = None,
                       camera_pos: Optional[torch.Tensor] = None):
        """The map-mode light pass on its own, for ``render(...,
        shadow_prepass=)``: (depth_map, world_to_clip, z_range, overflow,
        shear). Only for selections that do not follow the camera
        continuously: ``shadow_select="light"`` (a function of the sun,
        max height, scene and heightmap), or ``shadow_select="main"`` with
        ``shadow_eye_quant > 0`` and ``camera_pos`` (constant within a
        quant cell). Cached frames are bit-identical to inline ones."""
        cfg = self.config
        if cfg.shadow_mode != "map":
            raise ValueError("shadow_prepass needs shadow_mode='map'")
        quant_main = (cfg.shadow_select == "main"
                      and cfg.shadow_eye_quant > 0.0
                      and camera_pos is not None)
        if not (cfg.shadow_select == "light" or quant_main):
            raise ValueError(
                "the cached shadow map needs shadow_select='light' or "
                "shadow_select='main' with shadow_eye_quant > 0 and a "
                "camera_pos (the exact main-eye selection tracks the camera "
                "continuously)")
        if params is None:
            params = FrameParams.default(self.light, self.device)
        with torch.no_grad():
            return self._light_depth_pass(params, camera_pos,
                                          self._scene_wa(params))

    def cached_shadow_prepass(self, params: Optional[FrameParams] = None,
                              camera_pos: Optional[torch.Tensor] = None):
        """``shadow_prepass`` memoized on what it reads: the sun, max height,
        scene transforms and, under the quantized main eye, the eye's cell.
        Drive loops call it every frame."""
        cfg = self.config
        if params is None:
            params = FrameParams.default(self.light, self.device)
        cell = None
        if (cfg.shadow_select == "main" and cfg.shadow_eye_quant > 0.0
                and camera_pos is not None):
            cell = tuple(sync_copy(torch.floor(math3d.div_rn(
                camera_pos.to(torch.float32), cfg.shadow_eye_quant)).long(),
                "cpu").tolist())
        key = (sync_copy(params.light_direction.detach(), "cpu").numpy()
               .tobytes(),
               sync_copy(params.max_height.detach(), "cpu").numpy().tobytes(),
               None if self.scene_transforms is None
               else sync_copy(self.scene_transforms.detach(), "cpu").numpy()
               .tobytes(),
               cell)
        cached = self._shadow_prepass_cache
        if cached is None or cached[0] != key:
            self._shadow_prepass_cache = (
                key, self.shadow_prepass(params, camera_pos))
        return self._shadow_prepass_cache[1]

    def render_shadow_depth(self, params: Optional[FrameParams] = None
                            ) -> torch.Tensor:
        """The light-view depth map (z01) from the default eye: the
        reference's shadow phase (Renderer.cpp:333-380)."""
        if params is None:
            params = FrameParams.default(self.light, self.device)
        with torch.no_grad():
            return self._light_depth_pass(params, None,
                                          self._scene_wa(params))[0]

    # -- eye adaptation and lock-view --------------------------------------

    def render_adaptive(self, camera: Camera, params: FrameParams,
                        adapted_lum, dt: float, instances=None,
                        shadow_prepass=None):
        """Render with eye adaptation: (FrameOutput, new adapted luminance).
        Thread the returned luminance, a () tensor on the device, into the
        next call (seed it with 0.5, the clamp range's midpoint); nothing is
        read back to the host. ``instances``: a frozen selection
        (lock-view); it and ``shadow_prepass`` compose with adaptation, as
        every Animate feature does in the reference's loop
        (Renderer.cpp:188-204)."""
        lum = torch.as_tensor(adapted_lum, dtype=torch.float32,
                              device=self.device)
        with torch.no_grad():
            return self._frame_impl(camera, params, lock_instances=instances,
                                    adapt=(lum, float(dt)),
                                    shadow_prepass=shadow_prepass)

    def select(self, camera: Camera) -> quadtree.SelectedInstances:
        """LOD selection alone, for lock-view: EditorParams.m_LockView
        freezes the selection while the camera moves
        (TerrainPass.cpp:173,192-197)."""
        ts = self.config.terrain
        vc = self._view(camera)
        planes = math3d.frustum_planes(vc["world_to_clip"])
        with torch.no_grad():
            return quadtree.select_all_surfaces(ts, vc["camera_pos"], planes,
                                                self.lod_ranges)

    def render_locked(self, camera: Camera, params: FrameParams,
                      instances: quadtree.SelectedInstances) -> FrameOutput:
        """Render with a frozen selection (lock-view): the camera moves, the
        LOD selection stays ``instances`` (from ``select``)."""
        with torch.no_grad():
            return self._frame_impl(camera, params, lock_instances=instances)

    # -- editor surface -----------------------------------------------------

    def debug_selection(self, camera: Camera) -> quadtree.SelectionDebug:
        """Per-level selected and frustum-culled masks of the quadtree, the
        reference's green and red debug cubes (Renderer.cpp:481-513); for
        single-surface worlds, as in the JAX package."""
        ts = self.config.terrain
        vc = self._view(camera)
        with torch.no_grad():
            return quadtree.select_nodes(
                ts, vc["camera_pos"],
                math3d.frustum_planes(vc["world_to_clip"]),
                self.lod_ranges)[1]

    def reload_pipelines(self):
        """The shader hot-reload (m_ShaderReoladRequested, Renderer.cpp:
        226-231): drops what the renderer caches between frames, the
        horizon and shadow-map prepasses and the state copied to other
        devices for screen bands, so that the next frame recomputes them; it
        renders bit-identically. The CUDA kernels' library stays loaded: a
        live process cannot unload it, and there is nothing to
        recompile."""
        self._horizon_prepass_cache = None
        self._shadow_prepass_cache = None
        self._band_replicas = {}
