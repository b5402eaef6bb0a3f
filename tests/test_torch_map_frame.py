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
ldr 3.1e-4). So ``assert_light_depth_close`` (tests/test_torch_map_cache.py,
with the golden map frame and the cached prepasses) holds the port's own
light pass to the stored op-by-op pass, at least as closely as the jitted JAX
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
from vrenderer_tpu_torch.renderer import Renderer

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
