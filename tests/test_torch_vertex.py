"""Parity of the port's texture sampling, vertex stage and triangle setup
with the JAX package, on the same numpy inputs."""

import numpy as np
import pytest
import torch

from torch_parity import JSET, SET, W, H, assert_close, cameras, t
from vrenderer_tpu import camera as jcamera
from vrenderer_tpu.ops import raster as jraster
from vrenderer_tpu.ops import texture as jtexture
from vrenderer_tpu.ops import vertex as jvertex
from vrenderer_tpu.terrain import grid as jgrid
from vrenderer_tpu.terrain import quadtree as jquadtree
from vrenderer_tpu.utils import math3d as jmath3d
from vrenderer_tpu_torch import convert
from vrenderer_tpu_torch.ops import raster as traster
from vrenderer_tpu_torch.ops import texture as ttexture
from vrenderer_tpu_torch.ops import vertex as tvertex
from vrenderer_tpu_torch.terrain import grid as tgrid

_VIEWS = {
    "golden": ([0.0, 25.0, 45.0], [0.0, 0.0, 0.0]),
    "frontal": ([0.0, 20.0, 40.0], [0.0, 0.0, 0.0]),
    "oblique": ([25.0, 8.0, 25.0], [-10.0, 2.0, -10.0]),
}


def _textures(seed=0, res=64):
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res),
                       indexing="ij")
    hm = (0.5 + 0.3 * np.sin(x * 7.1) * np.cos(y * 5.3)
          + 0.05 * rng.random((res, res))).astype(np.float32)
    alb = rng.random((res, res, 3)).astype(np.float32)
    shad = rng.random((res, res)).astype(np.float32)
    return hm, alb, shad


def test_texture_samplers_match():
    rng = np.random.default_rng(1)
    tex = rng.random((40, 56, 3)).astype(np.float32)
    u = rng.uniform(-0.1, 1.1, (5, 17)).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, (5, 9)).astype(np.float32)
    # float32 products summed in another order: ~1 ulp of values <= 1
    assert_close(ttexture.sample_separable(t(tex), t(u), t(v)),
                 jtexture.sample_separable(tex, u, v), atol=1e-6)
    assert_close(ttexture.sample_separable(t(tex[..., 0]), t(u), t(v)),
                 jtexture.sample_separable(tex[..., 0], u, v), atol=1e-6)
    pu, pv = rng.uniform(-0.1, 1.1, (2, 40)).astype(np.float32)
    assert_close(ttexture.sample_points_matmul(t(tex), t(pu), t(pv)),
                 jtexture.sample_points_matmul(tex, pu, pv), atol=1e-6)
    assert_close(ttexture.sample_points(t(tex), t(pu), t(pv)),
                 jtexture.sample_points(tex, pu, pv), atol=1e-6)


def test_normal_fields_and_morph_k_match():
    hm, _, _ = _textures()
    assert_close(tvertex.normal_fields(t(hm)), jvertex.normal_fields(hm),
                 atol=1e-6)
    d = np.linspace(0.0, 100.0, 57, dtype=np.float32)
    ext = np.float32(8.0)
    assert_close(tvertex.morph_k(t(d), torch.tensor(ext), SET.lod_ranges()),
                 jvertex.morph_k(d, ext, JSET.lod_ranges()), atol=1e-6)


def _vertex_pair(view):
    eye, target = _VIEWS[view]
    jcam, tcam = cameras(eye, target)
    jvc = jcamera.make_view_constants(jcam, W, H, 60.0, 0.1, 1000.0)
    inst = jquadtree.select_all_surfaces(
        JSET, jvc["camera_pos"], jmath3d.frustum_planes(jvc["world_to_clip"]),
        JSET.lod_ranges())
    hm, alb, shad = _textures()
    mh = np.float32(12.0)
    jout = jvertex.vertex_stage(JSET, inst, jvc["camera_pos"], hm, alb, shad,
                                mh, JSET.lod_ranges())
    tinst = convert.selected_instances(*(np.asarray(x) for x in inst))
    tout = tvertex.vertex_stage(SET, tinst, t(jvc["camera_pos"]), t(hm),
                                t(alb), t(shad), torch.tensor(mh),
                                SET.lod_ranges())
    return jout, tout, inst, jvc


@pytest.mark.parametrize("view", sorted(_VIEWS))
def test_vertex_stage_matches(view):
    jout, tout, _, _ = _vertex_pair(view)
    # positions up to ~40 m and attrs in [0, 1]; float32 sampling products
    # summed in another order
    assert_close(tout.world, jout.world, atol=1e-5)
    assert_close(tout.attrs, jout.attrs, atol=1e-5)


@pytest.mark.parametrize("view", sorted(_VIEWS))
def test_setup_components_match(view):
    """The same vertices through both setups: validity is identical and
    every coefficient of a triangle that owns a pixel agrees to rtol 1e-5
    (a few edge coefficients round differently in sqrt/divide order)."""
    jout, _, inst, jvc = _vertex_pair(view)
    _, jtris = jgrid.make_grid(JSET.grid_size)
    _, ttris = tgrid.make_grid(SET.grid_size)
    wtc = np.asarray(jvc["world_to_clip"])
    jc = jraster.setup_components(jout.world, jout.attrs, inst.valid, jtris,
                                  wtc, W, H)
    tc = traster.setup_components(t(jout.world), t(jout.attrs),
                                  t(inst.valid), ttris, t(wtc), W, H)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    jsetup = jraster.setup_triangles(jout.world, jout.attrs, inst.valid,
                                     jtris, wtc, W, H)
    _, ids, _ = jraster.rasterize_xla(jsetup, W, H, tile=(8, 128), batch=64)
    owners = np.unique(np.asarray(ids))
    owners = owners[owners >= 0]
    assert owners.size > 100
    I, T = tc.valid.shape
    jmaps = list(jc.edge) + [m for q in jc.quant for m in q] + list(jc.bbox)
    tmaps = list(tc.edge) + [m for q in tc.quant for m in q] + list(tc.bbox)
    for k, (jm, tm) in enumerate(zip(jmaps, tmaps)):
        a = tm.numpy().reshape(-1)[owners]
        b = np.asarray(jm).reshape(-1)[owners]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-30,
                                   err_msg=f"map {k}")
    for jm, tm in zip(jc.vert_clip, tc.vert_clip):
        assert_close(tm, jm, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("view,uv_mode", [("golden", "lattice"),
                                          ("oblique", "d3d")])
def test_vertex_stage_exact_matches(view, uv_mode):
    """The test oracle (terrain_vs.hlsl:35-62: morph, then sample at the
    morphed position) against JAX's, in both texel modes; and it agrees
    with the lattice vertex stage at the unmorphed vertices."""
    import dataclasses

    from vrenderer_tpu.config import TerrainSettings as JTerrainSettings

    jset = JTerrainSettings(**dict(dataclasses.asdict(JSET), uv_mode=uv_mode))
    tset = dataclasses.replace(SET, uv_mode=uv_mode)
    jout, tout, inst, jvc = _vertex_pair(view)
    hm, _, _ = _textures()
    mh = np.float32(12.0)
    want = jvertex.vertex_stage_exact(jset, inst, jvc["camera_pos"], hm, mh,
                                      jset.lod_ranges())
    tinst = convert.selected_instances(*(np.asarray(x) for x in inst))
    got = tvertex.vertex_stage_exact(tset, tinst, t(jvc["camera_pos"]),
                                     t(hm), torch.tensor(mh),
                                     tset.lod_ranges())
    assert got.shape == tout.world.shape
    assert_close(got, want, atol=1e-5)
