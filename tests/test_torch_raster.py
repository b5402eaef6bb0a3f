"""The port's rasterizer against the JAX package's Pallas kernel (interpret
mode) and its XLA oracle, on the same triangle setup, and the work list's
count and overflow drop. The semantics the CUDA kernel must keep (ties,
-0.0, NaN, scissor) are in tests/test_torch_raster_kernel.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import JSET, SET, W, H, cameras, t
from vrenderer_tpu import camera as jcamera
from vrenderer_tpu.ops import raster as jraster
from vrenderer_tpu.ops import raster_pallas
from vrenderer_tpu.ops import vertex as jvertex
from vrenderer_tpu.terrain import grid as jgrid
from vrenderer_tpu.terrain import quadtree as jquadtree
from vrenderer_tpu.utils import math3d as jmath3d
from vrenderer_tpu_torch.ops import raster as traster
from vrenderer_tpu_torch.ops import raster_cuda
from vrenderer_tpu_torch.terrain import grid as tgrid

T = JSET.tris_per_instance
I = JSET.max_instances


def _scene(eye, target):
    """The terrain scene of tests/test_raster_pallas.py. The JAX stages
    (view, selection, vertex stage, setup) run as one jitted computation:
    one compile instead of the eager stages' many (about 15 s a process),
    and both packages rasterize the same jitted setup."""
    rng = np.random.default_rng(0)
    hm = (0.5 + 0.45 * np.sin(np.linspace(0, 6, 64))[None, :]
          * np.cos(np.linspace(0, 5, 64))[:, None]).astype(np.float32)
    alb = rng.random((64, 64, 3)).astype(np.float32)
    shad = rng.random((64, 64)).astype(np.float32)
    jcam, _ = cameras(eye, target)
    return _jax_scene(jcam, hm, alb, shad)


@jax.jit
def _jax_scene(jcam, hm, alb, shad):
    vc = jcamera.make_view_constants(jcam, W, H, 60.0, 0.1, 1000.0)
    inst, _ = jquadtree.select_nodes(
        JSET, jcam.eye, jmath3d.frustum_planes(vc["world_to_clip"]),
        JSET.lod_ranges())
    vout = jvertex.vertex_stage(JSET, inst, jcam.eye, hm, alb, shad,
                                jnp.float32(12.0), JSET.lod_ranges())
    _, tris = jgrid.make_grid(JSET.grid_size)
    setup = jraster.setup_triangles(vout.world, vout.attrs, inst.valid, tris,
                                    vc["world_to_clip"], W, H)
    return inst, vout, setup, vc


def _port_work(inst, vout, vc, max_work):
    """The port's instance bboxes and work list from the same vertices."""
    _, tris = tgrid.make_grid(SET.grid_size)
    comp = traster.setup_components(
        t(vout.world), t(vout.attrs), t(inst.valid), tris,
        t(vc["world_to_clip"]), W, H)
    bbox, usable, dist = raster_cuda.instance_bbox_components(
        comp, W, H, t(inst.valid))
    return raster_cuda.build_work_list(bbox, usable, W, H, 128, max_work,
                                       dist)


@functools.partial(jax.jit, static_argnames="max_work")
def _jax_work(inst, vout, vc, packed, max_work):
    """JAX's instance bboxes and work list, jitted (one compile instead of
    the eager ops' many)."""
    bbox, usable, dist = raster_pallas.instance_screen_bbox(
        vout.world, vc["world_to_clip"], W, H, inst.valid)
    return raster_pallas.build_work_list(
        bbox, usable, W, H, tile=128, tris_per_inst=T, max_work=max_work,
        order_key=dist, packed=packed, compact_k=16)


_VIEWS = {"frontal": ([0.0, 20.0, 40.0], [0.0, 0.0, 0.0]),
          "oblique": ([25.0, 8.0, 25.0], [-10.0, 2.0, -10.0])}


@functools.lru_cache(maxsize=None)
def _view_scene(view):
    """``_scene`` of one of _VIEWS, built once per test process."""
    return _scene(*_VIEWS[view])


@functools.lru_cache(maxsize=None)
def _oracles(view, **mode):
    """(JAX oracle, port oracle) outputs on ``view``'s setup, computed once
    per test process for each ``mode`` (reverse_z, wire_px); callers only
    read them."""
    setup = _view_scene(view)[2]
    return (jraster.rasterize_xla(setup, W, H, tile=(8, 128), batch=64,
                                  **mode),
            traster.rasterize_xla(traster.TriSetup(*(t(x) for x in setup)),
                                  W, H, batch=64, **mode))


@pytest.mark.parametrize("view", sorted(_VIEWS))
def test_plain_raster_matches_pallas_and_oracle(view):
    """Bounds of tests/test_raster_pallas.py:80-84: ids exact, z 1e-6
    (both evaluate a*px + b*py + c in float32), attrs 3e-4 (the attribute
    planes of tiny distant triangles cancel; the oracle sums them through
    a matmul in another order)."""
    inst, vout, setup, vc = _view_scene(view)
    z_x, id_x, at_x = _oracles(view)[0]
    packed = raster_pallas.pack_tri_data(setup, I, T, tri_batch=64)
    work = _jax_work(inst, vout, vc, packed, 256)
    z_p, id_p, at_p, _ = raster_pallas.rasterize_pallas(
        packed, work, W, H, tile=128, sub_h=8, compact_k=16, max_work=256,
        interpret=True)

    tsetup = traster.TriSetup(*(t(x) for x in setup))
    twork = _port_work(inst, vout, vc, 256)
    assert int(twork.num_items) == int(work.num_items)
    z, ids, attrs = raster_cuda.rasterize(raster_cuda.pack_setup(tsetup, I),
                                          twork, W, H)
    ids = ids.numpy()
    cov = np.asarray(id_x) >= 0
    assert cov.sum() > 1000
    for ref_z, ref_id, ref_at in ((z_p, id_p, at_p), (z_x, id_x, at_x)):
        np.testing.assert_array_equal(ids, np.asarray(ref_id))
        np.testing.assert_allclose(z.numpy()[cov], np.asarray(ref_z)[cov],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(attrs.numpy()[cov],
                                   np.asarray(ref_at)[cov], atol=3e-4)
    # background: far z, zero attributes (the Pallas finalize's 0/1)
    assert np.all(z.numpy()[~cov] == raster_cuda.F32_FAR)
    assert np.all(attrs.numpy()[~cov] == 0.0)


@pytest.mark.parametrize("max_work", [256, 40, 8])
def test_work_list_count_and_overflow_drop_match(max_work):
    """num_work_items counts one dummy per supertile plus every overlapping
    (usable instance, supertile) pair; on overflow the same items survive
    as in the JAX work list."""
    inst, vout, setup, vc = _view_scene("oblique")
    packed = raster_pallas.pack_tri_data(setup, I, T, tri_batch=64)
    work = _jax_work(inst, vout, vc, packed, max_work)
    twork = _port_work(inst, vout, vc, max_work)
    assert int(twork.num_items) == int(work.num_items)
    meta = np.asarray(work.meta)
    real = meta[5] == 1                       # item_valid: not a dummy
    expect = np.stack([meta[1][real], meta[0][real]], axis=1)
    items = twork.items.numpy()
    got = items[items[:, 0] >= 0]
    np.testing.assert_array_equal(got, expect)
    if max_work < 256:
        assert int(work.num_items) > max_work


@pytest.mark.parametrize("view", sorted(_VIEWS))
def test_oracle_port_matches_jax_oracle(view):
    (z_x, id_x, at_x), (z, ids, attrs) = _oracles(view)
    cov = np.asarray(id_x) >= 0
    np.testing.assert_array_equal(ids.numpy(), np.asarray(id_x))
    np.testing.assert_allclose(z.numpy()[cov], np.asarray(z_x)[cov], atol=1e-6)
    # the JAX oracle resolves attributes through a float32 matmul
    np.testing.assert_allclose(attrs.numpy()[cov], np.asarray(at_x)[cov],
                               atol=3e-4)


@pytest.mark.parametrize("view,mode", [
    ("frontal", dict(reverse_z=True)),
    ("oblique", dict(reverse_z=True, wire_px=0.5))],
    ids=["frontal-reverse_z", "oblique-reverse_z_wire"])
def test_oracle_modes_match_jax_oracle(view, mode):
    """The dense oracle's reverse-z (the farthest z wins, ties to the
    lowest id) and wireframe fill (within wire_px of an edge) against the
    JAX oracle's: ids exact, z 1e-6 where covered and the background
    (+-F32_FAR) exact elsewhere, attrs 3e-4."""
    (z_x, id_x, at_x), (z, ids, attrs) = _oracles(view, **mode)
    cov = np.asarray(id_x) >= 0
    assert 0.05 < cov.mean() < 1.0
    np.testing.assert_array_equal(ids.numpy(), np.asarray(id_x))
    np.testing.assert_allclose(z.numpy()[cov], np.asarray(z_x)[cov], atol=1e-6)
    np.testing.assert_array_equal(z.numpy()[~cov], np.asarray(z_x)[~cov])
    np.testing.assert_allclose(attrs.numpy()[cov], np.asarray(at_x)[cov],
                               atol=3e-4)
    # the mode changes the result: reverse-z picks other winners, the
    # wireframe leaves triangle interiors open
    _, plain_ids, _ = _oracles(view)[1]
    assert (ids != plain_ids).any()
    if mode.get("wire_px"):
        assert (ids.numpy() >= 0).sum() < (plain_ids.numpy() >= 0).sum()
