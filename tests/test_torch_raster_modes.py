"""Reverse-z and wireframe, the two modes of the visibility kernel: the
port's rasterizer against the JAX package's Pallas kernel (interpret mode)
and XLA oracle on the terrain scene of tests/test_torch_raster.py, and the
port's frames against the JAX renderer at the settings of
tests/test_world_modes.py and tests/test_editor_features.py, in both
shadow modes."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_raster import I, T, _VIEWS, _jax_work, _port_work, _scene
from torch_parity import CFG, JCFG, cameras, frame_params_pair, H, t, W
from vrenderer_tpu.ops import raster as jraster
from vrenderer_tpu.ops import raster_pallas
from vrenderer_tpu_torch.config import RasterSettings
from vrenderer_tpu_torch.ops import raster as traster
from vrenderer_tpu_torch.ops import raster_cuda


@pytest.fixture(scope="module", params=sorted(_VIEWS))
def both(request):
    """One view's triangle setup for both packages: (JAX setup, packed
    triangles and work list; the port's packed triangles and work list)."""
    inst, vout, setup, vc = _scene(*_VIEWS[request.param])
    packed = raster_pallas.pack_tri_data(setup, I, T, tri_batch=64)
    tpacked = raster_cuda.pack_setup(traster.TriSetup(*(t(x) for x in setup)),
                                     I)
    return (setup, packed, _jax_work(inst, vout, vc, packed, 256), tpacked,
            _port_work(inst, vout, vc, 256))


def _pallas(packed, work, **kw):
    return raster_pallas.rasterize_pallas(
        packed, work, W, H, tile=128, sub_h=8, compact_k=16, max_work=256,
        interpret=True, **kw)[:3]


def _assert_matches(out, ref, atol_attrs=3e-4):
    """Ids exact, z 1e-6 (interpret mode and the oracle contract plane
    evaluations into FMAs, ROADMAP.md section C), attrs 3e-4."""
    z, ids, attrs = (x.numpy() for x in out)
    ref_z, ref_id, ref_at = (np.asarray(x) for x in ref)
    cov = ref_id >= 0
    np.testing.assert_array_equal(ids, ref_id)
    np.testing.assert_allclose(z[cov], ref_z[cov], rtol=0, atol=1e-6)
    np.testing.assert_allclose(attrs[cov], ref_at[cov], atol=atol_attrs)
    assert np.all(attrs[~cov] == 0.0)
    return cov


def test_reverse_z_matches_pallas_and_oracle(both):
    setup, packed, work, tpacked, twork = both
    out = raster_cuda.rasterize(tpacked, twork, W, H, reverse_z=True)
    for ref in (_pallas(packed, work, reverse_z=True),
                jraster.rasterize_xla(setup, W, H, tile=(8, 128), batch=64,
                                      reverse_z=True)):
        cov = _assert_matches(out, ref)
    assert cov.sum() > 1000
    assert np.all(out[0].numpy()[~cov] == -raster_cuda.F32_FAR)
    # the farthest layer wins: never nearer than the forward-z winner
    fwd = raster_cuda.rasterize(tpacked, twork, W, H)[0].numpy()
    assert np.all(out[0].numpy()[cov] >= fwd[cov])
    assert np.any(out[0].numpy()[cov] > fwd[cov])
    for a, b in zip(raster_cuda.rasterize_two_phase(tpacked, twork, W, H,
                                                    reverse_z=True), out):
        assert torch.equal(a, b)


def test_wireframe_matches_pallas_and_oracle(both):
    setup, packed, work, tpacked, twork = both
    out = raster_cuda.rasterize(tpacked, twork, W, H, wire_px=1.0)
    for ref in (_pallas(packed, work, wire_px=1.0),
                jraster.rasterize_xla(setup, W, H, tile=(8, 128), batch=64,
                                      wire_px=1.0)):
        cov = _assert_matches(out, ref)
    fill = raster_cuda.rasterize(tpacked, twork, W, H)[1].numpy() >= 0
    assert cov.sum() > 500 and np.all(fill[cov])


def _jax_frame(raster_kw, eye, target):
    """The JAX renderer's frame (XLA oracle raster, jitted) with
    ``RasterSettings(**raster_kw)``."""
    from vrenderer_tpu.config import RasterSettings as JRasterSettings
    from vrenderer_tpu.renderer import Renderer as JRenderer
    from vrenderer_tpu.terrain import heightmap as jh

    hm = jh.procedural_heightmap(64, seed=7)
    jr = JRenderer(dataclasses.replace(JCFG,
                                       raster=JRasterSettings(**raster_kw)),
                   hm, jh.procedural_albedo(hm), raster_backend="xla")
    jcam, _ = cameras(eye, target)
    jp, _ = frame_params_pair()
    return jr.render(jcam, jp)


def _port_frame(raster_kw, eye, target, **cfg_kw):
    """The port's frame on the CPU with ``RasterSettings(**raster_kw)``."""
    from vrenderer_tpu_torch.renderer import Renderer
    from vrenderer_tpu_torch.terrain import heightmap as th

    cfg = dataclasses.replace(CFG, raster=RasterSettings(**raster_kw),
                              **cfg_kw)
    hm = th.procedural_heightmap(64, seed=7)
    _, cam = cameras(eye, target)
    _, params = frame_params_pair()
    return Renderer(cfg, hm, th.procedural_albedo(hm),
                    device="cpu").render(cam, params)


def _assert_frames_close(jo, o):
    """tests/test_torch_frame.py's bounds against the jitted JAX frame,
    whose FMA-contracted setup moves a few silhouette pixels."""
    prim = o.prim_id.numpy()
    assert (prim == np.asarray(jo.prim_id)).mean() >= 0.999
    assert np.abs(o.ldr.numpy() - np.asarray(jo.ldr)).mean() < 5e-4
    assert int(o.overflow_mask) == int(jo.overflow_mask)


def test_reverse_z_frame_matches_jax_renderer():
    """tests/test_world_modes.py's frame: the same coverage as forward-z,
    the farthest layer's ids."""
    view = ([0.0, 25.0, 45.0], [0.0, 0.0, 0.0])
    o = _port_frame({"reverse_z": True}, *view)
    _assert_frames_close(_jax_frame({"reverse_z": True}, *view), o)
    fwd = _port_frame({}, *view)
    assert torch.equal(o.prim_id >= 0, fwd.prim_id >= 0)
    assert not torch.equal(o.prim_id, fwd.prim_id)


def test_wireframe_frame_matches_jax_renderer():
    """tests/test_editor_features.py's close-up (its selection overflows
    the 64-instance budget in both packages): the interiors of near
    triangles open up, and wire pixels are a subset of filled ones."""
    view = ([2.0, 13.0, 1.0], [0.0, 10.0, -2.0])
    o = _port_frame({"wireframe": True}, *view)
    _assert_frames_close(_jax_frame({"wireframe": True}, *view), o)
    wire = o.prim_id >= 0
    filled = _port_frame({}, *view).prim_id >= 0
    assert int((filled & ~wire).sum()) > 300
    assert bool(filled[wire].all())


def test_every_raster_setting_renders_in_map_mode():
    """Map-mode shadows (128x128 light map) with each raster setting: the
    two-phase frame equals the single-phase one, reverse-z covers the same
    pixels, wireframe a subset of them; every frame finite."""
    outs = {}
    for name, kw in (("fill", {}), ("two_phase", {"two_phase": True}),
                     ("reverse_z", {"reverse_z": True}),
                     ("wireframe", {"wireframe": True})):
        o = _port_frame(kw, [0.0, 25.0, 45.0], [0.0, 0.0, 0.0],
                        shadow_mode="map", shadow_resolution=128)
        assert torch.isfinite(o.hdr).all() and not bool(o.overflow)
        outs[name] = o
    for f in outs["fill"]._fields:
        assert torch.equal(getattr(outs["fill"], f),
                           getattr(outs["two_phase"], f)), f
    filled = outs["fill"].prim_id >= 0
    assert 0.2 < float(filled.float().mean()) < 1.0
    assert torch.equal(outs["reverse_z"].prim_id >= 0, filled)
    wire = outs["wireframe"].prim_id >= 0
    assert bool(filled[wire].all()) and int(wire.sum()) < int(filled.sum())
