"""View constants, the sun's light-view matrices and LOD selection give the
same bits on every device as on the host: at ground-height eyes
(workloads' ``mapwalk`` and ``ground``) frustum planes through the eye cut
the selection's boxes at its height, so a last-bit difference in the
planes or in the order of the frustum test's sum changes the selection.
On the card the port computes the matrices on the host and sums the
frustum test in x, y, z order (``camera.make_view_constants``,
``shadow.sun_shear_matrices``, ``math3d.frustum_intersects_box``).

So do the poses of the flythrough and the envelope (computed on the host),
and the vertex stage at the envelope's camera 40, whose last bits moved an
instance's bbox across a supertile edge on the card (ROADMAP C): the
texture products as fused multiply-adds of their two taps
(``math3d.fma32``), the morph distance and the normal's length through a
correctly rounded sqrt (``math3d.sqrt_rn``) and the squares summed in
order.

So do the horizon prepass at the envelope's camera 40 and the map
samplers from one depth map (ROADMAP C1): the card's true division by a
Python number multiplies by its reciprocal, so they divide by a tensor on
the card (``math3d.div_rn``).

CPU cases check the host path; CUDA cases (marker ``cuda``) skip where
there is no card. The file imports no JAX, so on the machine with the card
it runs without the repository's conftest:

    python -m pytest tests/test_torch_view_devices.py --noconftest -q
"""

import pytest
import torch

from vrenderer_tpu_torch import workloads
from vrenderer_tpu_torch.camera import Camera, make_view_constants
from vrenderer_tpu_torch.ops import shadow, texture, vertex
from vrenderer_tpu_torch.terrain import quadtree
from vrenderer_tpu_torch.utils import math3d


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device(request.param)


def _equal(a, b):
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("mode", ["mapwalk", "ground"])
def test_view_and_selection_bits_match_the_host(device, mode):
    r, params, cams = workloads.build(mode, device="cpu")
    cfg = r.config
    ts = cfg.terrain
    args = (cfg.width, cfg.height, cfg.vfov_degrees, cfg.z_near, cfg.z_far)
    for i in range(workloads.N_CAMERAS):
        host = cams.frame(i)
        cam = Camera(*(f.to(device) for f in host))
        vc, vc_h = make_view_constants(cam, *args), make_view_constants(
            host, *args)
        for k, v in vc.items():
            assert v.device.type == device.type and _equal(v, vc_h[k]), (i, k)
        sel = quadtree.select_all_surfaces(
            ts, cam.eye, math3d.frustum_planes(vc["world_to_clip"]),
            ts.lod_ranges(device))
        sel_h = quadtree.select_all_surfaces(
            ts, host.eye, math3d.frustum_planes(vc_h["world_to_clip"]),
            ts.lod_ranges())
        assert int(sel.count) == int(sel_h.count) > 0, i
        for f in ("position", "extents", "lod", "valid"):
            assert _equal(getattr(sel, f), getattr(sel_h, f)), (i, f)


def test_sun_shear_matrices_bits_match_the_host(device):
    _, params, _ = workloads.build("mapwalk", device="cpu")
    for res in (128, 1024, 2048):
        got = shadow.sun_shear_matrices(params.light_direction.to(device),
                                        2048.0, params.max_height.to(device),
                                        res)
        want = shadow.sun_shear_matrices(params.light_direction, 2048.0,
                                         params.max_height, res)
        for a, b in zip(got, want):
            assert a.device.type == device.type and _equal(a, b)


@pytest.mark.parametrize("mode", ["envelope", "1080p"])
def test_poses_bits_match_the_host(device, mode):
    from vrenderer_tpu_torch.terrain import heightmap

    world = float(workloads.config(mode).terrain.world_size)
    hm = heightmap.procedural_heightmap(256)
    got = workloads.cameras(mode, hm.to(device), world)
    want = workloads.cameras(mode, hm, world)
    for a, b in zip(got, want):
        assert a.device.type == device.type and _equal(
            a.view(torch.int32), b.view(torch.int32))


def test_vertex_stage_bits_match_the_host(device):
    """world and attrs of the vertex stage at envelope camera 40 (1024
    slots), and the samplers alone, from the host's inputs."""
    r, params, cams = workloads.build("envelope", device="cpu")
    ts = r.config.terrain
    vc = r._view(cams.frame(40))
    lr = ts.lod_ranges()
    inst = r._clip_active(quadtree.select_all_surfaces(
        ts, vc["camera_pos"], math3d.frustum_planes(vc["world_to_clip"]),
        lr))
    field = shadow.horizon_shadow_field(r.heightmap, params.max_height,
                                        float(ts.world_size),
                                        params.light_direction)
    host = (inst, vc["camera_pos"], r.heightmap, params.max_height, lr,
            r.albedo, field, r._nrm_field)

    def stage(inst, eye, hm, max_h, lr, albedo, field, nrm):
        geom = vertex.vertex_geometry(ts, inst, eye, hm, max_h, lr)
        return geom, vertex.vertex_attrs(ts, geom, albedo, field, nrm)

    def to(x):
        if isinstance(x, quadtree.SelectedInstances):
            return type(x)(*(f.to(device) for f in x))
        return x.to(device)

    geom_h, attrs_h = stage(*host)
    geom, attrs = stage(*map(to, host))
    for a, b in ((geom.world, geom_h.world), (attrs, attrs_h)):
        assert a.device.type == device.type and _equal(
            a.view(torch.int32), b.view(torch.int32))
    vis = torch.cat([r.albedo, r._nrm_field, field[..., None]], dim=-1)
    for tex in (r.heightmap, vis):
        for mode in ("lattice", "d3d"):
            got = texture.sample_separable(tex.to(device),
                                           geom_h.u.to(device),
                                           geom_h.v.to(device), mode=mode)
            want = texture.sample_separable(tex, geom_h.u, geom_h.v,
                                            mode=mode)
            assert _equal(got.view(torch.int32), want.view(torch.int32))
        pu, pv = geom_h.u.reshape(-1), geom_h.v.reshape(-1)
        got = texture.sample_points_matmul(tex.to(device), pu.to(device),
                                           pv.to(device))
        assert _equal(got.view(torch.int32),
                      texture.sample_points_matmul(tex, pu, pv)
                      .view(torch.int32))


def test_horizon_prepass_bits_match_the_host(device):
    """The renderer's prepass at envelope camera 40 (the boot cube's
    mesh-top field, then the march), field and shadow line."""
    r_h, params_h, cams = workloads.build("envelope", device="cpu")
    r, params, _ = workloads.build("envelope", device=device)
    want = workloads.frame_prepass(r_h, params_h, cams.eye[40], "envelope")
    got = workloads.frame_prepass(r, params, cams.eye[40].to(device),
                                  "envelope")
    for a, b in zip(got, want):
        assert a.device.type == device.type and _equal(
            a.view(torch.int32), b.view(torch.int32))


# mapwalk's camera 62 rasters the most light work items (JAX's counts)
@pytest.mark.parametrize("mode,camera", [("map", 13), ("mapwalk", 62)])
def test_map_sampler_bits_match_the_host(device, mode, camera):
    """The terrain factors (``factors_from_sun_shear_map``) and the PCF
    factors of ``shadow_factors_from_map`` at the boot cube's vertices and
    the terrain lattice, from the host's 256^2 light pass."""
    r_h, params_h, cams = workloads.build(mode, device="cpu", shadow_res=256)
    r, params, _ = workloads.build(mode, device=device, shadow_res=256)
    depth, wtc, z_range, _, shear = r_h._light_depth_pass(
        params_h, cams.eye[camera], r_h._scene_wa(params_h))
    got = r.shadow_field_from_map(depth.to(device),
                                  tuple(v.to(device) for v in shear), params)
    want = r_h.shadow_field_from_map(depth, shear, params_h)
    assert got.device.type == device.type and _equal(
        got.view(torch.int32), want.view(torch.int32))
    ws = float(r_h.config.terrain.world_size)
    sw = r_h._scene_wa(params_h)[0]
    mesh = torch.cat([sw[b, :3 * n]
                      for b, n in enumerate(r_h._scene_block_nreal)])
    g = math3d.linspace(-ws / 2, ws / 2, r_h.heightmap.shape[0])
    n = g.shape[0]
    lattice = torch.stack([g[None, :].expand(n, n),
                           r_h.heightmap * params_h.max_height,
                           g[:, None].expand(n, n)], -1).reshape(-1, 3)
    for pts in (mesh, lattice):
        got = shadow.shadow_factors_from_map(depth.to(device), wtc.to(device),
                                             z_range, pts.to(device))
        want = shadow.shadow_factors_from_map(depth, wtc, z_range, pts)
        assert _equal(got.view(torch.int32), want.view(torch.int32))
