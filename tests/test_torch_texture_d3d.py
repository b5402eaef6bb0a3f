"""The "d3d" texel addressing of vrenderer_tpu_torch (texel centres at
half-integers under uv * size - 0.5, border clamp: the reference's
SampleLevel with a linear-clamp sampler) against vrenderer_tpu's and
against ``torch.nn.functional.grid_sample`` (align_corners=False, border
padding), the convention tests/test_texture_d3d.py holds JAX to."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import JSET, SET, W, H, assert_close, cameras, t
from vrenderer_tpu import camera as jcamera
from vrenderer_tpu.config import TerrainSettings as JTerrainSettings
from vrenderer_tpu.ops import texture as jtexture
from vrenderer_tpu.ops import vertex as jvertex
from vrenderer_tpu.terrain import quadtree as jquadtree
from vrenderer_tpu.utils import math3d as jmath3d
from vrenderer_tpu_torch import convert
from vrenderer_tpu_torch.ops import texture as ttexture
from vrenderer_tpu_torch.ops import vertex as tvertex


def _grid_sample(tex, u, v):
    """grid_sample oracle at points (u, v) in [0, 1] (grid in [-1, 1])."""
    c = tex if tex.ndim == 3 else tex[..., None]
    img = torch.from_numpy(np.ascontiguousarray(c)).permute(2, 0, 1)[None]
    grid = torch.from_numpy(np.stack([u * 2.0 - 1.0, v * 2.0 - 1.0],
                                     -1))[None, None]
    out = F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                        align_corners=False)[0, :, 0].T.numpy()
    return out if tex.ndim == 3 else out[:, 0]


@pytest.mark.parametrize("channels", [(), (3,)])
def test_d3d_samplers_match_jax_and_grid_sample(channels):
    rng = np.random.default_rng(len(channels))
    tex = rng.random((33, 57) + channels, dtype=np.float32)
    u = rng.uniform(-0.2, 1.2, 300).astype(np.float32)
    v = rng.uniform(-0.2, 1.2, 300).astype(np.float32)
    for k in (0, 1, 2):
        np.testing.assert_array_equal(
            ttexture.texel_coords(t(u), 57 - k, "d3d").numpy(),
            np.asarray(jtexture.texel_coords(u, 57 - k, "d3d")))
    want = _grid_sample(tex, u, v)
    for fn in ("sample_points", "sample_points_matmul"):
        got = getattr(ttexture, fn)(t(tex), t(u), t(v), mode="d3d")
        assert_close(got, getattr(jtexture, fn)(tex, u, v, mode="d3d"),
                     atol=1e-6)
        assert_close(got, want, atol=2e-6)
    us, vs = u[:17], v[:13]
    got = ttexture.sample_separable(t(tex), t(us), t(vs), mode="d3d")
    assert_close(got, jtexture.sample_separable(tex, us, vs, mode="d3d"),
                 atol=1e-6)
    uu, vv = np.meshgrid(us, vs)
    assert_close(got, _grid_sample(tex, uu.ravel(), vv.ravel())
                 .reshape(got.shape), atol=2e-6)
    with pytest.raises(ValueError, match="addressing"):
        ttexture.texel_coords(t(u), 8, "nearest")


def test_vertex_stage_d3d_matches_jax():
    """uv_mode="d3d" reaches the vertex stage: positions and attributes
    match JAX's d3d stage to 1e-6, and differ from the lattice stage's by
    the half-texel shift."""
    jset = JTerrainSettings(**dict(dataclasses.asdict(JSET), uv_mode="d3d"))
    tset = dataclasses.replace(SET, uv_mode="d3d")
    rng = np.random.default_rng(3)
    hm = (np.linspace(0, 1, 64, dtype=np.float32)[None, :]
          * np.ones((64, 1), np.float32) + 0.02 * rng.random((64, 64))
          ).astype(np.float32)
    alb = rng.random((64, 64, 3)).astype(np.float32)
    shad = rng.random((64, 64)).astype(np.float32)
    jcam, _ = cameras([0.0, 30.0, 40.0], [0.0, 0.0, 0.0])
    vc = jcamera.make_view_constants(jcam, W, H, 60.0, 0.1, 1000.0)
    inst, _ = jquadtree.select_nodes(
        jset, jcam.eye, jmath3d.frustum_planes(vc["world_to_clip"]),
        jset.lod_ranges())
    mh = np.float32(12.0)
    jout = jvertex.vertex_stage(jset, inst, jcam.eye, hm, alb, shad, mh,
                                jset.lod_ranges())
    tinst = convert.selected_instances(*(np.asarray(x) for x in inst))
    args = (tinst, t(jcam.eye), t(hm), t(alb), t(shad), torch.tensor(mh),
            tset.lod_ranges())
    tout = tvertex.vertex_stage(tset, *args)
    assert_close(tout.world, jout.world, atol=1e-6)
    assert_close(tout.attrs, jout.attrs, atol=1e-6)
    lattice = tvertex.vertex_stage(SET, *args)
    valid = tinst.valid
    diff = (tout.world[valid][..., 1] - lattice.world[valid][..., 1]).abs()
    assert 1e-4 < float(diff.max()) < 0.5
