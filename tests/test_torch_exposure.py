"""Eye adaptation and lock-view of vrenderer_tpu_torch against
vrenderer_tpu on the CPU: ``lighting.adapt_exposure``, a
``render_adaptive`` chain, ``select`` + ``render_locked`` in both shadow
modes, and adaptation composed with a frozen selection and a prepass.

The luminance is held to rtol 1e-5: torch and XLA sum the covered pixels'
log2 luminance in other orders, so the last bits differ, and the carry
compounds them over frames. Frames are held to tests/test_torch_frame.py's
bounds against the jitted JAX frame: a few silhouette pixels change owner
(XLA's FMA contraction in the setup), so the count of those pixels, the
mean, and the max where the owner agrees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_map_frame import N_TERRAIN, _jax_light_pass
from test_torch_map_frame import renderers as map_renderers
from torch_parity import CFG, JCFG, cameras, frame_params_pair
from vrenderer_tpu_torch import convert
from vrenderer_tpu_torch.ops import lighting, raster_cuda
from vrenderer_tpu_torch.renderer import Renderer

# (adapted luminance, HDR scale, dt, covered share): the eye adapting up
# and down, short and long steps, both clamps, an all-background frame
CASES = {
    "rising": (0.1, 2.0, 1.0 / 60.0, 0.6),
    "falling": (3.0, 0.2, 1.0 / 60.0, 0.6),
    "rising_long_dt": (0.1, 2.0, 0.5, 0.6),
    "falling_long_dt": (3.0, 0.2, 0.5, 0.6),
    "clamp_max": (3.9, 1000.0, 100.0, 1.0),
    "clamp_min": (0.03, 1e-9, 100.0, 1.0),
    "all_background": (0.5, 1.0, 0.25, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adapt_exposure_matches_jax(case):
    from vrenderer_tpu.ops import lighting as jlighting

    lum0, scale, dt, cov = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    hdr = (rng.lognormal(0.0, 1.0, (48, 64, 3)) * scale).astype(np.float32)
    covered = rng.random((48, 64)) < cov
    j_lum, j_scale = jlighting.adapt_exposure(
        jnp.asarray(hdr), jnp.asarray(covered), jnp.float32(lum0),
        jnp.float32(dt))
    lum, s = lighting.adapt_exposure(
        torch.tensor(hdr), torch.tensor(covered), torch.tensor(lum0), dt)
    np.testing.assert_allclose(float(lum), float(j_lum), rtol=1e-5)
    np.testing.assert_allclose(float(s), float(j_scale), rtol=1e-5)
    assert lum.dtype == torch.float32 and lum.shape == ()


@pytest.fixture(scope="module")
def horizon_pair():
    """The golden configuration's JAX renderer (XLA rasterizer) and the
    port's, on the same heightmap."""
    from vrenderer_tpu.renderer import Renderer as JRenderer
    from vrenderer_tpu.terrain import heightmap as jh
    from vrenderer_tpu_torch.terrain import heightmap as th

    jhm = jh.procedural_heightmap(64, seed=7)
    jr = JRenderer(JCFG, jhm, jh.procedural_albedo(jhm), raster_backend="xla")
    hm = th.procedural_heightmap(64, seed=7)
    return jr, Renderer(CFG, hm, th.procedural_albedo(hm), device="cpu")


def _bright_params():
    """tests/test_exposure.py's bright sun, so the eye moves off 0.5."""
    jp, params = frame_params_pair()
    jp = jp._replace(light_irradiance=jnp.float32(3.0))
    return jp, params._replace(light_irradiance=torch.tensor(3.0))


def _assert_frames_close(o, jo, min_cube_px=0):
    """tests/test_torch_frame.py's bounds against the jitted JAX frame (the
    XLA rasterizer counts no work items)."""
    jprim = np.asarray(jo.prim_id)
    prim = o.prim_id.numpy()
    assert (prim >= N_TERRAIN).sum() >= min_cube_px
    assert int(o.num_instances) == int(jo.num_instances)
    assert int(o.overflow_mask) == int(jo.overflow_mask)
    same = prim == jprim
    assert same.mean() >= 0.999
    d = np.abs(o.ldr.numpy() - np.asarray(jo.ldr))
    assert d.mean() < 5e-4
    assert d[same].max() < 5e-3


def test_render_adaptive_chain_matches_jax(horizon_pair):
    """Three frames threading the adapted luminance, camera moving."""
    jr, r = horizon_pair
    jp, params = _bright_params()
    j_lum, lum = 0.5, torch.tensor(0.5)
    for i in range(3):
        jcam, cam = cameras([2.0 * i, 25.0 - i, 45.0 - 2.0 * i],
                            [0.0, 0.0, 0.0])
        jo, j_lum = jr.render_adaptive(jcam, jp, j_lum, 0.25)
        o, lum = r.render_adaptive(cam, params, lum, 0.25)
        np.testing.assert_allclose(float(lum), float(j_lum), rtol=1e-5)
        _assert_frames_close(o, jo)
    assert abs(float(lum) - 0.5) > 1e-2      # the eye adapted


def test_select_and_render_locked_match_jax(horizon_pair):
    """Select at camera A, render at camera B: the port's selection equals
    JAX's, and the locked frame matches JAX's locked frame."""
    jr, r = horizon_pair
    jp, params = frame_params_pair()
    jcam_a, cam_a = cameras([0.0, 25.0, 45.0], [0.0, 0.0, 0.0])
    jcam_b, cam_b = cameras([10.0, 20.0, 30.0], [2.0, 0.0, 0.0])
    jsel = jr.select(jcam_a)
    sel = r.select(cam_a)
    for f in ("position", "extents", "lod", "valid", "count"):
        np.testing.assert_array_equal(getattr(sel, f).numpy(),
                                      np.asarray(getattr(jsel, f)), f)
    o = r.render_locked(cam_b, params, sel)
    _assert_frames_close(o, jr.render_locked(jcam_b, jp, jsel))
    # the frozen selection is not camera B's own
    assert not torch.equal(o.prim_id, r.render(cam_b, params).prim_id)


def test_render_locked_map_mode_matches_jax(monkeypatch):
    """Map mode: a locked frame shares no geometry with the light pass (the
    light pass selects from camera B's eye, the main pass keeps A's
    selection). The light raster's z comes from the JAX pass, as in
    tests/test_torch_map_frame.py."""
    jr, r = map_renderers(True, {"raster_backend": "xla"})
    jp, params = frame_params_pair()
    jcam_a, cam_a = cameras([0.0, 25.0, 45.0], [0.0, 0.0, 0.0])
    jcam_b, cam_b = cameras([6.0, 24.0, 40.0], [3.0, 9.0, 2.0])
    jsel = jr.select(jcam_a)
    jz = torch.tensor(np.asarray(_jax_light_pass(jr, jp, jcam_b.eye)[0]))
    monkeypatch.setattr(raster_cuda, "rasterize_depth",
                        lambda vis, work, w, h, tile=128: jz.clone())
    sel = convert.selected_instances(*(np.asarray(x) for x in jsel))
    jo = jr.render_locked(jcam_b, jp, jsel)
    o = r.render_locked(cam_b, params, sel)
    _assert_frames_close(o, jo, min_cube_px=200)
    # sharing would have rendered camera B's own selection
    assert not torch.equal(o.prim_id, r.render(cam_b, params).prim_id)


def test_render_adaptive_composes_with_lock_and_prepass():
    """``instances=`` and ``shadow_prepass=`` together with adaptation: the
    frame equals the locked frame at the adapted exposure, and the
    luminance equals the unlocked prepass frame's where the selection is
    the camera's own."""
    from vrenderer_tpu_torch.models.scene import Scene
    from vrenderer_tpu_torch.terrain import heightmap as th

    hm = th.procedural_heightmap(64, seed=7)
    r = Renderer(CFG, hm, th.procedural_albedo(hm), scene=Scene.default(),
                 device="cpu")
    _, params = _bright_params()
    _, cam = cameras([0.0, 25.0, 45.0], [0.0, 0.0, 0.0])
    prepass = r.cached_horizon_prepass(params)
    sel = r.select(cam)
    o, lum = r.render_adaptive(cam, params, 0.5, 0.25, instances=sel,
                               shadow_prepass=prepass)
    o2, lum2 = r.render_adaptive(cam, params, 0.5, 0.25)
    assert torch.equal(lum, lum2)
    for f in ("ldr", "hdr", "depth", "prim_id", "overflow_mask"):
        assert torch.equal(getattr(o, f), getattr(o2, f)), f
    locked = r.render_locked(cam, params._replace(
        exposure=params.exposure * (0.5 / lum)), sel)
    assert torch.equal(o.ldr, locked.ldr)
    assert abs(float(lum) - 0.5) > 1e-3
