"""Map-mode shadows of vrenderer_tpu_torch on the CPU, in
tests/test_torch_map_frame.py's configuration (its module docstring says
why the light pass is held to the stored op-by-op JAX pass): the port's own
light pass against ``golden_map_frame_unfused.npz``, the golden map frame,
overflow bit 4 against the JAX renderer, and the cached prepasses (light-eye
and quantized-eye maps: cached frames bit-identical to inline ones, cache
keys). The frames against the JAX renderer's are in
tests/test_torch_map_frame.py; the two files are split so that parallel
workers can take them apart."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_map_frame import (
    GOLDEN_EYE, GOLDEN_MAP, GOLDEN_TARGET, N_TERRAIN, _jax_light_pass,
    _jax_scene, _port_scene, jcfg, renderers,
)
from torch_parity import cameras, frame_params_pair
from vrenderer_tpu_torch import convert
from vrenderer_tpu_torch.ops import raster_cuda
from vrenderer_tpu_torch.renderer import Renderer, overflow_message


def port_renderer(cube=True, **cfg_kw):
    """The port's renderer of ``renderers``, without building the JAX
    one."""
    from vrenderer_tpu_torch.terrain import heightmap as th

    hm = th.procedural_heightmap(64, seed=7)
    return Renderer(convert.frame_config(dataclasses.asdict(jcfg(**cfg_kw))),
                    hm, th.procedural_albedo(hm),
                    scene=_port_scene(_jax_scene()) if cube else None,
                    device="cpu")


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
    r = port_renderer(cube, shadow_select="light")
    _, params = frame_params_pair()
    prepass = r.cached_shadow_prepass(params)
    for i in range(3):
        _assert_same_frame(r.render(_cam(i), params),
                           r.render(_cam(i), params, shadow_prepass=prepass))


def test_cache_invalidates_on_sun_and_scene_change():
    r = port_renderer(True, shadow_select="light")
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
    r = port_renderer(True, shadow_eye_quant=16.0)
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
    r = port_renderer(False)
    _, params = frame_params_pair()
    with pytest.raises(ValueError, match="shadow_select"):
        r.shadow_prepass(params)
    with pytest.raises(ValueError, match="horizon"):
        r.horizon_shadow_prepass(params)


def test_map_frame_launches_no_kernel_on_cpu():
    r = port_renderer(True)
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
