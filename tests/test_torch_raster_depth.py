"""The port's depth-only rasterizer (the CPU path of kernel B2) against the
JAX package's Pallas depth kernel ``rasterize_pallas_depth`` (interpret
mode, as tests/test_raster_pallas.py runs it) on the same triangle setup.
Views: the terrain scenes of tests/test_raster_pallas.py, and the map-mode
light view (the sheared sun projection of a 128x128 light map).

Bounds: the same pixels covered, z within 1e-6 (the bound of
tests/test_torch_raster.py for the full kernel: XLA compiles the
interpreted kernel body with a*px + b*py + c contracted into FMAs, which
moves a few dozen z values by 1-2 ulp; the port rounds each operation, as
the kernel on the card does), and z bitwise equal to the port's full
rasterizer on the same triangles, as the Pallas depth kernel is to its own.

The semantics the CUDA kernel keeps on the card (ties, NaN, invalid
triangles, background) are in tests/test_torch_raster_kernel.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_raster import _VIEWS, I, T, _scene
from torch_parity import JCFG, JSET, SET, cameras, frame_params_pair, t
from vrenderer_tpu.ops import raster as jraster
from vrenderer_tpu.ops import raster_pallas
from vrenderer_tpu.ops import shadow as jshadow
from vrenderer_tpu.ops import vertex as jvertex
from vrenderer_tpu.terrain import grid as jgrid
from vrenderer_tpu_torch.ops import raster as traster
from vrenderer_tpu_torch.ops import raster_cuda
from vrenderer_tpu_torch.terrain import grid as tgrid

MAX_WORK = 256


def _light_scene():
    """The map-mode light pass's triangles for the golden camera: light
    selection and vertex geometry from the JAX renderer, set up in the
    sheared light view, jitted as one computation (one compile instead of
    the eager stages' many)."""
    import dataclasses

    import jax

    from vrenderer_tpu.renderer import Renderer as JRenderer
    from vrenderer_tpu.terrain import heightmap as jh

    res = 128
    hm = jh.procedural_heightmap(64, seed=7)
    jr = JRenderer(dataclasses.replace(JCFG, shadow_mode="map",
                                       shadow_resolution=res),
                   hm, jh.procedural_albedo(hm), raster_backend="xla")
    jcam, _ = cameras([0.0, 25.0, 45.0], [0.0, 0.0, 0.0])
    jp, _ = frame_params_pair()

    @jax.jit
    def light(jp, eye):
        wtc = jshadow.sun_shear_matrices(jp.light_direction, 64.0,
                                         jp.max_height, res)[0]
        inst, sel_eye, ranges = jr._light_select(jp, wtc, eye)
        geom = jvertex.vertex_geometry(JSET, inst, sel_eye, hm,
                                       jp.max_height, ranges)
        _, tris = jgrid.make_grid(JSET.grid_size)
        world = geom.world
        setup = jraster.setup_triangles(
            world, jnp.zeros(world.shape[:3] + (8,), jnp.float32),
            inst.valid, tris, wtc, res, res)
        return inst, world, setup, wtc

    return light(jp, jcam.eye) + (res, res)


def _inputs(view):
    if view == "light":
        inst, world, setup, wtc, w, h = _light_scene()
    else:
        inst, vout, setup, vc = _scene(*_VIEWS[view])
        world, wtc, (w, h) = vout.world, vc["world_to_clip"], (256, 128)
    packed = raster_pallas.pack_tri_data(setup, I, T, tri_batch=64)
    bbox, usable, dist = raster_pallas.instance_screen_bbox(
        world, wtc, w, h, inst.valid)
    work = raster_pallas.build_work_list(
        bbox, usable, w, h, tile=128, tris_per_inst=T, max_work=MAX_WORK,
        order_key=dist, packed=packed, compact_k=16)
    # the port's work list from the same vertices
    _, tris = tgrid.make_grid(SET.grid_size)
    no_attrs = np.zeros(world.shape[:3] + (0,), np.float32)
    comp = traster.setup_components(t(world), t(no_attrs), t(inst.valid),
                                    tris, t(wtc), w, h)
    tbbox, tusable, tdist = raster_cuda.instance_bbox_components(
        comp, w, h, t(inst.valid))
    twork = raster_cuda.build_work_list(tbbox, tusable, w, h, 128, MAX_WORK,
                                        tdist)
    tsetup = traster.TriSetup(*(t(x) for x in setup))
    return packed, work, tsetup, twork, w, h


@pytest.mark.parametrize("view", sorted(_VIEWS) + ["light"])
def test_depth_raster_matches_pallas_depth_kernel(view):
    packed, work, tsetup, twork, w, h = _inputs(view)
    z_d = np.asarray(raster_pallas.rasterize_pallas_depth(
        packed, work, w, h, tile=128, sub_h=8, compact_k=16,
        max_work=MAX_WORK, interpret=True))
    assert int(twork.num_items) == int(work.num_items)
    vis = raster_cuda.pack_vis(tsetup, I)
    before = raster_cuda.rasterize_depth.launches
    z = raster_cuda.rasterize_depth(vis, twork, w, h).numpy()
    assert raster_cuda.rasterize_depth.launches == before   # CPU: plain
    cov = z < 2.0
    assert cov.mean() > 0.05
    np.testing.assert_array_equal(cov, z_d < 2.0)
    np.testing.assert_allclose(z[cov], z_d[cov], rtol=0, atol=1e-6)
    assert np.all(z[~cov] == raster_cuda.F32_FAR)
    # each package's depth-only z is its full rasterizer's z channel
    z_full = raster_cuda.rasterize(raster_cuda.pack_setup(tsetup, I), twork,
                                   w, h)[0].numpy()
    np.testing.assert_array_equal(z, z_full)
    z_pfull = raster_pallas.rasterize_pallas(
        packed, work, w, h, tile=128, sub_h=8, compact_k=16,
        max_work=MAX_WORK, interpret=True)[0]
    np.testing.assert_array_equal(z_d, np.asarray(z_pfull))
