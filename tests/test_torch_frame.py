"""Whole frames of vrenderer_tpu_torch against vrenderer_tpu on the CPU.

The port runs every op eagerly, each rounded once, as the JAX package does
op by op (``jax.disable_jit()``). ``tests/golden_frame.npy`` was rendered
by the jitted JAX frame, where XLA's CPU fusion contracts products and sums
into FMAs in the vertex stage and triangle setup: the triangle edge
functions then differ in their last bits, and a few silhouette pixels,
where the owner switches between a near ridge and far terrain or sky,
change owner. The JAX package itself, run op by op, differs from its own
golden there by 0.26. So the per-pixel max bound is held against the
op-by-op JAX frame, ``golden_frame_unfused.npz`` (regenerate with
``PYTHONPATH=. python tests/test_torch_frame.py``), and the golden's mean, coverage and
probe ids are held as tests/test_golden.py holds them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import CFG, JCFG, SET, cameras, frame_params_pair, t
from vrenderer_tpu_torch import convert
from vrenderer_tpu_torch.ops import raster_cuda
from vrenderer_tpu_torch.renderer import Renderer

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden_frame.npy")
UNFUSED = os.path.join(HERE, "golden_frame_unfused.npz")
GOLDEN_EYE, GOLDEN_TARGET = [0.0, 25.0, 45.0], [0.0, 0.0, 0.0]


def _jax_renderer(**kw):
    from vrenderer_tpu.renderer import Renderer as JRenderer
    from vrenderer_tpu.terrain import heightmap as jh

    hm = jh.procedural_heightmap(64, seed=7)
    return JRenderer(JCFG, hm, jh.procedural_albedo(hm), **kw)


def _port_renderer_cfg(cfg, scene=None):
    from vrenderer_tpu_torch.terrain import heightmap as hmod

    hm = hmod.procedural_heightmap(64, seed=7)
    return Renderer(cfg, hm, hmod.procedural_albedo(hm), scene=scene,
                    device="cpu")


def _port_renderer(scene=None):
    return _port_renderer_cfg(CFG, scene)


def render_jax_op_by_op():
    """tests/test_golden.py's frame from the JAX package with jit disabled
    (about two minutes on one core): (ldr float16, prim_id int32)."""
    jcam, _ = cameras(GOLDEN_EYE, GOLDEN_TARGET)
    jp, _ = frame_params_pair()
    r = _jax_renderer(raster_backend="xla")
    with jax.disable_jit():
        out = r.render(jcam, jp)
    return (np.asarray(out.ldr).astype(np.float16),
            np.asarray(out.prim_id).astype(np.int32))


def test_golden_frame():
    _, cam = cameras(GOLDEN_EYE, GOLDEN_TARGET)
    _, params = frame_params_pair()
    out = _port_renderer().render(cam, params)
    ldr = out.ldr.numpy()
    prim = out.prim_id.numpy()

    # op-by-op JAX frame: the same ops rounded the same way, so the owner
    # of every pixel is equal; the bound covers float16 storage and
    # last-bit differences of the two libraries' exp/pow in the lighting
    ref = np.load(UNFUSED)
    np.testing.assert_array_equal(prim, ref["prim_id"])
    assert np.abs(ldr - ref["ldr"].astype(np.float32)).max() < 5e-3

    # tests/test_golden.py's bounds on the jitted golden: mean, coverage
    # and probe ids hold; the max only off the few silhouette pixels whose
    # owner XLA's FMA contraction moves (module docstring)
    golden = np.load(GOLDEN).astype(np.float32)
    diff = np.abs(ldr - golden)
    assert diff.mean() < 5e-4
    assert (diff.max(-1) >= 5e-3).sum() <= 16      # of 32768 pixels
    np.testing.assert_allclose((prim >= 0).mean(), 0.552856, atol=0.002)
    assert prim[64, 128] == 2144
    assert prim[100, 200] == 3589


def test_scene_frame_matches_pallas_renderer():
    """A cube floating in view (clear of the terrain, so no intersection
    line z-fights), with its horizon shadow prepass, against the JAX
    renderer on the Pallas rasterizer (interpret mode)."""
    from vrenderer_tpu.models import mesh as jmesh
    from vrenderer_tpu.models import scene as jscene
    from vrenderer_tpu.utils import math3d as jm3

    xf = jm3.affine_translation(jnp.asarray([4.0, 17.0, 6.0], jnp.float32))
    js = jscene.Scene(instances=[jscene.MeshInstance(
        mesh=jmesh.cube(6.0, color=(0.9, 0.05, 0.05)), transform=xf)])
    scene = convert.scene([
        {**{k: np.asarray(v) for k, v in i.mesh._asdict().items()},
         "transform": np.asarray(i.transform)} for i in js.instances])
    jcam, cam = cameras([6.0, 24.0, 40.0], [3.0, 9.0, 2.0])
    jp, params = frame_params_pair()

    jr = _jax_renderer(raster_backend="pallas", interpret=True, scene=js)
    r = _port_renderer(scene)
    jo = jr.render(jcam, jp, shadow_prepass=jr.cached_horizon_prepass(jp))
    o = r.render(cam, params, shadow_prepass=r.cached_horizon_prepass(params))

    jprim = np.asarray(jo.prim_id)
    prim = o.prim_id.numpy()
    n_terrain = SET.max_instances * SET.tris_per_instance
    assert (prim >= n_terrain).sum() > 200, "the cube must be in view"
    assert int(o.num_work_items) == int(jo.num_work_items)
    assert int(o.num_instances) == int(jo.num_instances)
    assert not bool(o.overflow)
    # the jitted JAX frame fuses FMAs into the setup (module docstring), so
    # a few edge pixels change owner: along shared terrain edges the
    # neighbours' attributes agree, at silhouettes they do not. Those
    # pixels bound the count, the rest the value.
    same = prim == jprim
    assert same.mean() >= 0.999
    d = np.abs(o.ldr.numpy() - np.asarray(jo.ldr))
    assert d.mean() < 5e-4
    # where the owner agrees, the same planes are evaluated at the same
    # pixel: the bound covers last-bit differences in setup and lighting
    assert d[same].max() < 5e-3


def test_render_launches_no_kernel_on_cpu():
    """CPU tensors take the plain rasterizer: the launch counter stays."""
    _, cam = cameras(GOLDEN_EYE, GOLDEN_TARGET)
    _, params = frame_params_pair()
    before = raster_cuda.rasterize.launches
    out = _port_renderer().render(cam, params)
    assert raster_cuda.rasterize.launches == before
    assert out.ldr.dtype == torch.float32 and out.ldr.device.type == "cpu"
    assert tuple(out.ldr.shape) == (CFG.height, CFG.width, 3)
    assert torch.isfinite(t(out.hdr.numpy())).all()


def test_unported_paths_raise():
    """Every path that once raised runs now: every raster setting builds;
    a frame rendered as one screen band of its full height equals the
    whole frame bit for bit (tests/test_torch_sharded.py holds the bands
    to the JAX package); the selection debug view and pipeline reload run
    (tests/test_torch_editor.py holds them to the JAX package)."""
    import dataclasses

    from vrenderer_tpu_torch.config import RasterSettings

    for kw in ({"two_phase": True}, {"reverse_z": True}, {"wireframe": True}):
        _port_renderer_cfg(dataclasses.replace(CFG,
                                               raster=RasterSettings(**kw)))
    r = _port_renderer()
    cam, params = cameras(GOLDEN_EYE, GOLDEN_TARGET)[1], frame_params_pair()[1]
    whole = r._frame_impl(cam, params)
    band = r._frame_impl(cam, params, band=(0, CFG.height))
    for f in whole._fields:
        assert torch.equal(getattr(band, f), getattr(whole, f)), f
    assert r.debug_selection(cam).selected.any()
    r.reload_pipelines()


def test_two_phase_slot_cap_raises_at_construction():
    """The two-phase resolve takes at most MAX_RESOLVE_INSTANCES instance
    slots (the render budget plus the scene's blocks): a renderer beyond it
    raises when it is built and names the way out, instead of failing on its
    first frame; at the cap, and beyond it without two_phase or under
    wireframe (which ignores two_phase), it builds."""
    import dataclasses

    import pytest

    from vrenderer_tpu_torch.config import RasterSettings, TerrainSettings
    from vrenderer_tpu_torch.models.scene import Scene

    cap = raster_cuda.MAX_RESOLVE_INSTANCES

    def cfg(max_instances, **raster_kw):
        return dataclasses.replace(
            CFG, raster=RasterSettings(**raster_kw),
            terrain=TerrainSettings(surface_size=64, world_size=64,
                                    max_instances=max_instances, grid_size=8))

    with pytest.raises(ValueError, match="two_phase=False") as err:
        _port_renderer_cfg(cfg(cap + 1, two_phase=True))
    assert str(cap) in str(err.value)
    with pytest.raises(ValueError, match="two_phase=False"):
        _port_renderer_cfg(cfg(cap, two_phase=True), Scene.default())
    _port_renderer_cfg(cfg(cap, two_phase=True))
    _port_renderer_cfg(cfg(cap + 1))
    _port_renderer_cfg(cfg(cap + 1, two_phase=True, wireframe=True))


def test_renderer_defaults_to_the_card(monkeypatch):
    """Without ``device`` the Renderer takes the CUDA device; where there
    is none it raises and names ``device="cpu"``, which renders."""
    import pytest

    from vrenderer_tpu_torch.terrain import heightmap as hmod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hm = hmod.procedural_heightmap(64, seed=7)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Renderer(CFG, hm, hmod.procedural_albedo(hm))
    _, cam = cameras(GOLDEN_EYE, GOLDEN_TARGET)
    _, params = frame_params_pair()
    r = Renderer(CFG, hm, hmod.procedural_albedo(hm), device="cpu")
    out = r.render(cam, params)
    assert r.device.type == "cpu" and out.prim_id.device.type == "cpu"
    assert (out.prim_id >= 0).any()


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    ldr, prim = render_jax_op_by_op()
    np.savez_compressed(UNFUSED, ldr=ldr, prim_id=prim)
