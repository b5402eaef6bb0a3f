"""Map-mode frames of vrenderer_tpu_torch against vrenderer_tpu on the CPU.

Configuration: tests/test_shadow_interplay.py's frame (256x128, the small
terrain, ``shadow_resolution=128``) on the golden heightmap and camera.

The light view is the one place where the two packages' last-bit
differences grow. Its map pixels (0.8 m here) are larger than the finest
terrain cells (0.25 m), so most light-view triangles cover a fraction of a
pixel, and the clipless setup's determinant cancels by orders of
magnitude: the z planes carry errors around 1e-5 (0.2 m of height), and
CDLOD morph slivers (triangles a morph factor near 1 has almost
collapsed) up to 0.004 (75 m). A last-bit change in the vertex heights
(float32 matrix products summed in another order, XLA's FMA contraction
in a jitted pass) moves the depth map by those amounts, and the shadow
comparisons that read it (against a 2 m bias) flip at a few percent of
the texels. The JAX package shows this against itself: its jitted light
pass is within 1e-4 of its op-by-op pass at only 96.6% of the golden
view's covered pixels (93.8% from the default eye), and the jitted frame
differs from the op-by-op frame by a mean ldr of 1.3e-3. The port, op by
op in float32, stays closer to the op-by-op pass (99.6% and 99.3%, mean
ldr 3.1e-4). So ``assert_light_depth_close`` holds the port's own light
pass to the stored op-by-op pass, at least as closely as the jitted JAX
pass comes; given the same depth map, the rest of the frame agrees to the
bounds of tests/test_torch_frame.py, so the frame tests against the
jitted JAX renderer hand the port the JAX light pass's depth map (through
``raster_cuda.rasterize_depth``). The rasterizer is held to the Pallas
depth kernel on the same triangles in tests/test_torch_raster_depth.py.

``golden_map_frame_unfused.npz`` holds the JAX package's op-by-op
(``jax.disable_jit()``) map-mode frame with the boot-style cube, and its
light passes from the camera's eye and the default eye; chip_smoke.py
holds the card to it. Regenerate with ``PYTHONPATH=. python
tests/test_torch_map_frame.py`` (a few minutes).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import JCFG, SET, cameras, frame_params_pair
from vrenderer_tpu_torch import convert
from vrenderer_tpu_torch.ops import raster_cuda
from vrenderer_tpu_torch.renderer import Renderer, overflow_message

HERE = os.path.dirname(__file__)
GOLDEN_MAP = os.path.join(HERE, "golden_map_frame_unfused.npz")
GOLDEN_EYE, GOLDEN_TARGET = [0.0, 25.0, 45.0], [0.0, 0.0, 0.0]
CUBE_AT, CUBE_SIZE, CUBE_COLOR = [4.0, 17.0, 6.0], 6.0, (0.9, 0.05, 0.05)
N_TERRAIN = SET.max_instances * SET.tris_per_instance


def jcfg(**kw):
    return dataclasses.replace(JCFG, shadow_mode="map", shadow_resolution=128,
                               **kw)


def _jax_scene():
    from vrenderer_tpu.models import mesh as jmesh
    from vrenderer_tpu.models import scene as jscene
    from vrenderer_tpu.utils import math3d as jm3

    return jscene.Scene(instances=[jscene.MeshInstance(
        mesh=jmesh.cube(CUBE_SIZE, color=CUBE_COLOR),
        transform=jm3.affine_translation(jnp.asarray(CUBE_AT, jnp.float32)))])


def _port_scene(js):
    return convert.scene([
        {**{k: np.asarray(v) for k, v in i.mesh._asdict().items()},
         "transform": np.asarray(i.transform)} for i in js.instances])


def renderers(cube=True, jax_kw=None, **cfg_kw):
    """The JAX renderer (``jax_kw``: backend) and the port's on the same
    numpy state."""
    from vrenderer_tpu.renderer import Renderer as JRenderer
    from vrenderer_tpu.terrain import heightmap as jh
    from vrenderer_tpu_torch.terrain import heightmap as th

    cfg = jcfg(**cfg_kw)
    js = _jax_scene() if cube else None
    hm = jh.procedural_heightmap(64, seed=7)
    jr = JRenderer(cfg, hm, jh.procedural_albedo(hm), scene=js,
                   **(jax_kw or {}))
    thm = th.procedural_heightmap(64, seed=7)
    r = Renderer(convert.frame_config(dataclasses.asdict(cfg)), thm,
                 th.procedural_albedo(thm),
                 scene=_port_scene(js) if cube else None,
                 max_active=jr.max_active, device="cpu")
    return jr, r


def port_prepass(jax_prepass):
    """The JAX package's light-pass tuple as the port's."""
    depth, wtc, z_range, overflow, shear = jax_prepass
    return convert.shadow_prepass(np.asarray(depth), np.asarray(wtc), z_range,
                                  np.asarray(overflow),
                                  [np.asarray(v) for v in shear])


def _jax_light_pass(jr, jp, eye=None):
    def light(p, xf, e):
        wa = None if jr._scene_obj is None else jr._scene_blocks(
            xf, p.max_height)
        return jr._light_depth_pass(p, e, scene_wa=wa)

    return jax.jit(light)(jp, jr.scene_transforms, eye)


def assert_frames_close(o, jo, min_cube_px=0):
    """tests/test_torch_frame.py's bounds: the jitted JAX frame contracts
    the setup's products into FMAs, so a few edge pixels change owner;
    those bound the count, the rest the value."""
    jprim = np.asarray(jo.prim_id)
    prim = o.prim_id.numpy()
    assert (prim >= N_TERRAIN).sum() >= min_cube_px
    assert int(o.num_work_items) == int(jo.num_work_items)
    assert int(o.num_instances) == int(jo.num_instances)
    assert int(o.overflow_mask) == int(jo.overflow_mask)
    same = prim == jprim
    assert same.mean() >= 0.999
    d = np.abs(o.ldr.numpy() - np.asarray(jo.ldr))
    assert d.mean() < 5e-4
    assert d[same].max() < 5e-3


@pytest.mark.parametrize("cube", [True, False], ids=["cube", "nocube"])
@pytest.mark.parametrize("select", ["main", "light"])
def test_map_frame_matches_pallas_renderer(select, cube, monkeypatch):
    """Inline frames (under "main" the main pass shares the light pass's
    geometry) against the JAX renderer on the Pallas kernels (interpret
    mode), the light raster's z taken from the JAX pass (module
    docstring)."""
    jr, r = renderers(cube, {"raster_backend": "pallas", "interpret": True},
                      shadow_select=select)
    jcam, cam = cameras(GOLDEN_EYE, GOLDEN_TARGET)
    jp, params = frame_params_pair()
    jz = torch.tensor(np.asarray(_jax_light_pass(jr, jp, jcam.eye)[0]))
    jo = jr.render(jcam, jp)
    monkeypatch.setattr(raster_cuda, "rasterize_depth",
                        lambda vis, work, w, h, tile=128: jz.clone())
    o = r.render(cam, params)
    assert_frames_close(o, jo, min_cube_px=200 if cube else 0)
    assert not bool(o.overflow)


def light_depth(r, cam, params):
    """The light pass's depth map for ``cam`` through the public API."""
    res = r.config.shadow_resolution
    return raster_cuda.rasterize_depth(*r.light_raster_inputs(cam, params),
                                       res, res)


def close_share(d, ref):
    """Share of the pixels covered in both maps whose z is within 1e-4
    (2 m of height, the comparison bias)."""
    both = (d < 2.0) & (ref < 2.0)
    return (np.abs(d - ref)[both] <= 1e-4).mean()


def assert_light_depth_close(d, ref, jit=None):
    """A light depth map against the op-by-op JAX pass ``ref`` (module
    docstring): the same covered pixels, and z within 1e-4 on 99% of them
    (measured 99.6% from the camera's eye, 99.3% from the default eye);
    and at least as close as the jitted JAX pass ``jit`` comes."""
    cov, ref_cov = d < 2.0, ref < 2.0
    assert (cov == ref_cov).mean() >= 0.999
    assert cov.mean() > 0.2
    share = close_share(d, ref)
    assert share >= 0.99
    if jit is not None:
        assert share >= close_share(jit, ref)


def test_light_depth_matches_jax():
    """The port's own light pass against the stored op-by-op JAX pass, from
    the camera's eye and from render_shadow_depth's default eye, with the
    jitted JAX pass as the measure of the reference's own spread."""
    g = np.load(GOLDEN_MAP)
    jr, r = renderers(True, {"raster_backend": "xla"})
    jcam, cam = cameras(GOLDEN_EYE, GOLDEN_TARGET)
    jp, params = frame_params_pair()
    assert_light_depth_close(
        light_depth(r, cam, params).numpy(), g["depth"],
        jit=np.asarray(_jax_light_pass(jr, jp, jcam.eye)[0]))
    assert_light_depth_close(r.render_shadow_depth(params).numpy(),
                             g["depth_default"],
                             jit=np.asarray(jr.render_shadow_depth(jp)))


def test_prepass_frames_match_pallas_renderer():
    """Both packages render from the JAX light pass as a cached prepass
    (the camera-independent shadow_select="light" map)."""
    jr, r = renderers(True, {"raster_backend": "pallas", "interpret": True},
                      shadow_select="light")
    jcam, cam = cameras([6.0, 24.0, 40.0], [3.0, 9.0, 2.0])
    jp, params = frame_params_pair()
    jpre = jr.shadow_prepass(jp)
    jo = jr.render(jcam, jp, shadow_prepass=jpre)
    o = r.render(cam, params, shadow_prepass=port_prepass(jpre))
    assert_frames_close(o, jo, min_cube_px=200)


def test_shadow_budget_overflow_sets_bit_4():
    """tests/test_shadow_interplay.py:224: a budget below the whole-world
    light selection surfaces as overflow bit 4 (and bit 2: under "main"
    the frame reports the shared light selection's count)."""
    from vrenderer_tpu.renderer import Renderer as JRenderer
    from vrenderer_tpu.terrain import heightmap as jh
    from vrenderer_tpu_torch.terrain import heightmap as th

    cfg = jcfg()
    jhm = jh.procedural_heightmap(64, seed=5)
    jr = JRenderer(cfg, jhm, jh.procedural_albedo(jhm), raster_backend="xla",
                   max_active=4)
    hm = th.procedural_heightmap(64, seed=5)
    r = Renderer(convert.frame_config(dataclasses.asdict(cfg)), hm,
                 th.procedural_albedo(hm), max_active=4, device="cpu")
    jcam, cam = cameras(GOLDEN_EYE, [0.0, 2.0, 0.0])
    jp, params = frame_params_pair()
    o = r.render(cam, params)
    jo = jr.render(jcam, jp)
    assert bool(o.overflow) and int(o.overflow_mask) & 4
    assert int(o.overflow_mask) == int(jo.overflow_mask)
    assert int(o.num_selected) == int(jo.num_selected)
    assert "shadow-pass" in overflow_message(o, r)


def _cam(i=0):
    """tests/test_shadow_cache.py's cameras."""
    return cameras([3.0 + 2.0 * i, 26.0, 42.0 - 3.0 * i], [0.0, 0.0, 0.0])[1]


def _assert_same_frame(a, b):
    for f in ("ldr", "hdr", "depth", "prim_id", "overflow_mask"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("cube", [True, False], ids=["cube", "nocube"])
def test_cached_frames_bit_identical_to_inline(cube):
    """shadow_select="light": the whole-world map depends on no camera, so
    one prepass serves every frame, bit for bit."""
    _, r = renderers(cube, {"raster_backend": "xla"}, shadow_select="light")
    _, params = frame_params_pair()
    prepass = r.cached_shadow_prepass(params)
    for i in range(3):
        _assert_same_frame(r.render(_cam(i), params),
                           r.render(_cam(i), params, shadow_prepass=prepass))


def test_cache_invalidates_on_sun_and_scene_change():
    _, r = renderers(True, {"raster_backend": "xla"}, shadow_select="light")
    _, params = frame_params_pair()
    p1 = r.cached_shadow_prepass(params)
    assert r.cached_shadow_prepass(params)[0] is p1[0]
    moved = params._replace(light_direction=torch.tensor([0.5, -0.6, 0.1]))
    p3 = r.cached_shadow_prepass(moved)
    assert p3[0] is not p1[0]
    assert torch.equal(p3[0], r.shadow_prepass(moved)[0])
    # single-entry cache: switching back re-rasters the original map
    p4 = r.cached_shadow_prepass(params)
    assert p4[0] is not p1[0] and torch.equal(p4[0], p1[0])
    # moving the cube re-keys, and its shadow moves with it
    r.scene_transforms = r.scene_transforms.clone()
    r.scene_transforms[0, 3, 0] += 8.0
    p5 = r.cached_shadow_prepass(params)
    assert p5[0] is not p4[0] and not torch.equal(p5[0], p4[0])


def test_quantized_eye_cache_is_piecewise_constant_and_exact():
    """shadow_select="main" with shadow_eye_quant: the light pass reads
    only the snapped eye, so it is constant within a quant cell, cached
    frames equal inline frames anywhere in the cell, and crossing a cell
    re-keys the cache."""
    _, r = renderers(True, {"raster_backend": "xla"}, shadow_eye_quant=16.0)
    _, params = frame_params_pair()
    cam_a = _cam(0)
    cam_b = cam_a._replace(eye=cam_a.eye + torch.tensor([2.0, 1.0, -3.0]))
    z1 = r.shadow_prepass(params, camera_pos=cam_a.eye)[0]
    z2 = r.shadow_prepass(params,
                          camera_pos=torch.tensor([12.0, 18.0, 34.0]))[0]
    assert torch.equal(z1, z2)
    p_a = r.cached_shadow_prepass(params, camera_pos=cam_a.eye)
    assert r.cached_shadow_prepass(params, camera_pos=cam_b.eye)[0] is p_a[0]
    for cam in (cam_a, cam_b):
        _assert_same_frame(r.render(cam, params),
                           r.render(cam, params, shadow_prepass=p_a))
    cam_c = cam_a.eye + torch.tensor([20.0, 0.0, 0.0])
    p_c = r.cached_shadow_prepass(params, camera_pos=cam_c)
    assert p_c[0] is not p_a[0]
    assert torch.equal(p_c[0], r.shadow_prepass(params, camera_pos=cam_c)[0])


def test_prepass_rejects_camera_dependent_selection():
    _, r = renderers(False, {"raster_backend": "xla"})
    _, params = frame_params_pair()
    with pytest.raises(ValueError, match="shadow_select"):
        r.shadow_prepass(params)
    with pytest.raises(ValueError, match="horizon"):
        r.horizon_shadow_prepass(params)


def test_map_frame_launches_no_kernel_on_cpu():
    _, r = renderers(True, {"raster_backend": "xla"})
    _, params = frame_params_pair()
    before = (raster_cuda.rasterize.launches,
              raster_cuda.rasterize_depth.launches)
    out = r.render(_cam(), params)
    assert (raster_cuda.rasterize.launches,
            raster_cuda.rasterize_depth.launches) == before
    assert torch.isfinite(out.hdr).all() and not bool(out.overflow)


def test_golden_map_frame():
    """The port on the CPU, built as chip_smoke.py builds it on the card,
    against the op-by-op JAX map frame. Through the stored light pass (a
    prepass: the main pass selects on its own), the bounds of
    tests/test_torch_frame.py. Inline, the main pass shares the light
    pass's geometry and numbers prim ids in its slot order, and the port's
    own light raster differs at sliver pixels (module docstring): the
    covered, cube and light-map pixels agree, and the mean ldr stays below
    1e-3 (measured 3.1e-4; the jitted JAX frame is 1.3e-3 off)."""
    from chip_smoke import map_golden_renderer

    g = np.load(GOLDEN_MAP)
    r = map_golden_renderer(torch.device("cpu"))
    _, cam = cameras(GOLDEN_EYE, GOLDEN_TARGET)
    _, params = frame_params_pair()
    pre = convert.shadow_prepass(g["depth"], g["wtc"], g["z_range"],
                                 g["overflow"], g["shear"])
    o = r.render(cam, params, shadow_prepass=pre)
    prim = o.prim_id.numpy()
    assert (prim >= N_TERRAIN).sum() > 200
    same = prim == g["prim_id"]
    d = np.abs(o.ldr.numpy() - g["ldr"].astype(np.float32))
    assert same.mean() >= 0.999
    assert d.mean() < 5e-4 and d[same].max() < 5e-3
    inline = r.render(cam, params)
    for lo in (0, N_TERRAIN):            # covered pixels, then cube pixels
        assert ((inline.prim_id.numpy() >= lo)
                == (g["prim_id"] >= lo)).mean() >= 0.999
    assert np.abs(inline.ldr.numpy()
                  - g["ldr"].astype(np.float32)).mean() < 1e-3
    assert_light_depth_close(light_depth(r, cam, params).numpy(), g["depth"])


def render_jax_golden():
    """The golden map frame from the JAX package op by op (jit disabled):
    the light pass from the camera's eye (the XLA oracle rasterizer), the
    frame rendered from it as a prepass, and the light pass from
    ``render_shadow_depth``'s default eye."""
    from vrenderer_tpu.renderer import Renderer as JRenderer
    from vrenderer_tpu.terrain import heightmap as jh

    hm = jh.procedural_heightmap(64, seed=7)
    jr = JRenderer(jcfg(), hm, jh.procedural_albedo(hm), scene=_jax_scene(),
                   raster_backend="xla")
    jcam, _ = cameras(GOLDEN_EYE, GOLDEN_TARGET)
    jp, _ = frame_params_pair()
    with jax.disable_jit():
        wa = jr._scene_blocks(jr.scene_transforms, jp.max_height)
        depth, wtc, z_range, overflow, shear = jr._light_depth_pass(
            jp, jcam.eye, scene_wa=wa)
        out = jr._frame_impl(jcam, jp, None, shadow_prepass=(
            depth, wtc, z_range, overflow, shear))
        depth_default = jr._light_depth_pass(jp, scene_wa=wa)[0]
    return dict(ldr=np.asarray(out.ldr).astype(np.float16),
                prim_id=np.asarray(out.prim_id).astype(np.int32),
                depth=np.asarray(depth), wtc=np.asarray(wtc),
                depth_default=np.asarray(depth_default),
                z_range=np.float32(z_range),
                overflow=np.asarray(overflow).astype(np.int32),
                shear=np.asarray(shear, np.float32))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(GOLDEN_MAP, **render_jax_golden())
