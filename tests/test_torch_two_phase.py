"""Two-phase rasterization of the port (``raster_cuda.rasterize_zid``,
``filter_work_to_winners``, ``rasterize_resolve``, ``rasterize_two_phase``)
against the JAX package's ``rasterize_pallas_zid``,
``filter_work_to_winners`` and ``rasterize_pallas_two_phase`` (Pallas in
interpret mode) on the terrain scene of tests/test_torch_raster.py, and
against the port's own single-phase raster, which it must equal bit for
bit (raster_pallas.py:1229-1231, 1587-1589): on the two views, a ragged
frame and whole renderer frames."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_raster import I, T, _VIEWS, _port_work, _scene
from torch_parity import CFG, cameras, frame_params_pair, H, t, W
from vrenderer_tpu.ops import raster_pallas
from vrenderer_tpu_torch.config import RasterSettings
from vrenderer_tpu_torch.ops import raster as traster
from vrenderer_tpu_torch.ops import raster_cuda

MAX_WORK = 256
BIG_ID = raster_pallas._BIG_ID


@functools.partial(jax.jit, static_argnames="sub_h")
def _jax_work(inst, vout, vc, packed, sub_h):
    """JAX's work list with cells of ``sub_h`` rows, jitted (one compile
    instead of the eager ops' many)."""
    bbox, usable, dist = raster_pallas.instance_screen_bbox(
        vout.world, vc["world_to_clip"], W, H, inst.valid)
    return raster_pallas.build_work_list(
        bbox, usable, W, H, tile=128, tris_per_inst=T, max_work=MAX_WORK,
        order_key=dist, packed=packed, compact_k=16, sub_h=sub_h)


@pytest.fixture(scope="module", params=sorted(_VIEWS))
def case(request):
    """One view through both packages: the JAX phase-1 image (sub_h 16)
    and two-phase raster, and the port's packed triangles, work list and
    single-phase raster."""
    inst, vout, setup, vc = _scene(*_VIEWS[request.param])
    packed = raster_pallas.pack_tri_data(setup, I, T, tri_batch=64)
    work16 = _jax_work(inst, vout, vc, packed, 16)
    kw = dict(tile=128, sub_h=16, compact_k=16, max_work=MAX_WORK,
              interpret=True)
    z_pad, id_pad = raster_pallas.rasterize_pallas_zid(packed, work16, W, H,
                                                       **kw)
    # the Pallas merge leaves ids at uncovered pixels of cells its items ran
    # over (an all-background round ties the stored F32_FAR and takes the
    # lower id, raster_pallas.py:799-824); rasterize_pallas_two_phase masks
    # them by z (:1698-1700), and so does this phase-1 image
    z_pad, id_pad = np.asarray(z_pad), np.asarray(id_pad)
    id_pad = np.where(z_pad == raster_cuda.F32_FAR, BIG_ID, id_pad)
    two = raster_pallas.rasterize_pallas_two_phase(packed, work16, W, H, **kw)
    tpacked = raster_cuda.pack_setup(traster.TriSetup(*(t(x) for x in setup)),
                                     I)
    twork = _port_work(inst, vout, vc, MAX_WORK)
    return dict(
        inst=inst, vout=vout, vc=vc, packed=packed, work16=work16,
        z_pad=z_pad, id_pad=id_pad,
        two=[np.asarray(x) for x in two[:3]], tpacked=tpacked, twork=twork,
        single=raster_cuda.rasterize(tpacked, twork, W, H))


def test_zid_matches_pallas_zid(case):
    """Ids exact, z within 1e-6 (interpret mode contracts the plane
    evaluation into FMAs, ROADMAP.md section C), background F32_FAR; and z
    and id bit-identical to the port's single-phase raster."""
    z, ids = raster_cuda.rasterize_zid(case["tpacked"], case["twork"], W, H)
    jid = case["id_pad"][:H, :W]
    cov = jid != BIG_ID
    assert cov.sum() > 1000
    np.testing.assert_array_equal(ids.numpy(), np.where(cov, jid, -1))
    np.testing.assert_allclose(z.numpy()[cov], case["z_pad"][:H, :W][cov],
                               rtol=0, atol=1e-6)
    assert np.all(z.numpy()[~cov] == raster_cuda.F32_FAR)
    assert torch.equal(z, case["single"][0])
    assert torch.equal(ids, case["single"][1])


@pytest.mark.parametrize("sub_h", [16, 8])
def test_filter_matches_jax_filter(case, sub_h):
    """The live (item, cell) pairs against JAX's ``won`` mask: equal
    wherever JAX's work list has rounds (JAX zeroes the rest), a superset
    of JAX's live items (JAX's round counts also drop in-range instances
    that touch no triangle of the cell, which the port cannot see),
    conservative (every pair holding a winner is live), and smaller than
    the unfiltered work."""
    ids = case["single"][1]
    work = (case["work16"] if sub_h == 16 else
            _jax_work(case["inst"], case["vout"], case["vc"], case["packed"],
                      sub_h))
    jwork2 = raster_pallas.filter_work_to_winners(
        work, case["id_pad"], T, W, H, tile=128, sub_h=sub_h)
    twork2, live = raster_cuda.filter_work_to_winners(
        case["twork"], ids, T, W, H, tile=128, sub_h=sub_h)
    real = np.asarray(work.meta)[5] == 1
    n = int(real.sum())
    rounds = np.asarray(work.sub_rounds)[:, real].T           # (n, n_cell)
    rounds2 = np.asarray(jwork2.sub_rounds)[:, real].T
    jlive = np.asarray(jwork2.meta)[5][real] == 1
    plive = live.numpy()
    assert plive.shape == (MAX_WORK, 128 // sub_h)
    assert not plive[n:].any()
    np.testing.assert_array_equal(plive[:n][rounds > 0],
                                  (rounds2 > 0)[rounds > 0])
    assert plive[:n].any(axis=1)[jlive].all()
    # the live work list keeps the items with a live cell
    items = case["twork"].items.numpy()
    np.testing.assert_array_equal(
        twork2.items.numpy(),
        np.where(plive.any(axis=1)[:, None], items, -1))
    assert int(twork2.num_items) == int(case["twork"].num_items)
    # every pixel's winner lies in a live (item, cell) pair
    idn = ids.numpy()
    y, x = np.nonzero(idn >= 0)
    st = (y // 128) * (-(-W // 128)) + x // 128
    slot = {(int(i), int(s)): k for k, (i, s) in enumerate(items[:n])}
    k = np.array([slot[(int(i), int(s))]
                  for i, s in zip(idn[y, x] // T, st)])
    cell = ((y % 128) // sub_h)
    assert plive[k, cell].all()
    # work dropped: of the unfiltered pairs, and of the cells JAX runs
    assert plive.sum() < n * plive.shape[1]
    assert plive[:n][rounds > 0].sum() < (rounds > 0).sum()


def test_two_phase_matches_single_phase_and_pallas(case):
    """Bitwise equal to the port's ``rasterize``; against JAX's two-phase
    raster the bounds of tests/test_raster_pallas.py: ids exact, z 1e-6,
    attrs 3e-4."""
    out = raster_cuda.rasterize_two_phase(case["tpacked"], case["twork"],
                                          W, H)
    for a, b in zip(out, case["single"]):
        assert torch.equal(a, b)
    jz, jid, jat = case["two"]
    cov = jid >= 0
    np.testing.assert_array_equal(out[1].numpy(), jid)
    np.testing.assert_allclose(out[0].numpy()[cov], jz[cov], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(out[2].numpy()[cov], jat[cov], atol=3e-4)
    assert np.all(out[2].numpy()[~cov] == 0.0)


def _small_renderer(width=W, height=H, scene=None, **raster_kw):
    from vrenderer_tpu_torch.renderer import Renderer
    from vrenderer_tpu_torch.terrain import heightmap as hmod

    cfg = dataclasses.replace(CFG, width=width, height=height,
                              raster=RasterSettings(**raster_kw))
    hm = hmod.procedural_heightmap(64, seed=7)
    return Renderer(cfg, hm, hmod.procedural_albedo(hm), scene=scene,
                    device="cpu")


@pytest.mark.parametrize("sub_h", [16, 8])
def test_two_phase_on_a_ragged_frame(sub_h):
    """250x120: the last supertile column and row, and their cells, lie
    partly outside the frame."""
    _, cam = cameras([25.0, 8.0, 25.0], [-10.0, 2.0, -10.0])
    _, params = frame_params_pair()
    packed, work = _small_renderer(250, 120).raster_inputs(cam, params)
    for reverse_z in (False, True):
        ref = raster_cuda.rasterize(packed, work, 250, 120,
                                    reverse_z=reverse_z)
        out = raster_cuda.rasterize_two_phase(packed, work, 250, 120,
                                              sub_h=sub_h,
                                              reverse_z=reverse_z)
        assert 0.2 < float((ref[1] >= 0).float().mean()) < 1.0
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


def test_two_phase_renderer_frames():
    """A two-phase frame with the cube in view (horizon prepass) equals the
    single-phase frame in every output; the golden view's prim ids equal
    the op-by-op JAX frame's (tests/golden_frame_unfused.npz)."""
    import os

    from vrenderer_tpu_torch.models import mesh, scene
    from vrenderer_tpu_torch.utils import math3d

    cube = scene.Scene(instances=[scene.MeshInstance(
        mesh=mesh.cube(6.0, color=(0.9, 0.05, 0.05)),
        transform=math3d.affine_translation(torch.tensor([4.0, 17.0, 6.0])))])
    _, cam = cameras([6.0, 24.0, 40.0], [3.0, 9.0, 2.0])
    _, params = frame_params_pair()
    outs = []
    for two_phase in (False, True):
        r = _small_renderer(scene=cube, two_phase=two_phase)
        outs.append(r.render(cam, params,
                             shadow_prepass=r.cached_horizon_prepass(params)))
    n_terrain = CFG.terrain.max_instances * CFG.terrain.tris_per_instance
    assert int((outs[0].prim_id >= n_terrain).sum()) > 200
    for name, a, b in zip(outs[0]._fields, outs[0], outs[1]):
        assert torch.equal(a, b), name

    _, cam = cameras([0.0, 25.0, 45.0], [0.0, 0.0, 0.0])
    out = _small_renderer(two_phase=True).render(cam, params)
    ref = np.load(os.path.join(os.path.dirname(__file__),
                               "golden_frame_unfused.npz"))
    np.testing.assert_array_equal(out.prim_id.numpy(), ref["prim_id"])
