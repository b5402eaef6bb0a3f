"""The sharded screen-band path of vrenderer_tpu_torch against
vrenderer_tpu on the CPU, at tests/test_sharded.py's size: 256x512, the
64 m world of ``procedural_heightmap(64, seed=3)``, max_instances 64, grid
8, the cube scene, a (2, 4) mesh (2 frame rows of 4 bands).

The band bound is tests/test_sharded.py's: band rendering rebases the
planes (c + b*y0), whose float32 rounding differs from the whole frame's
at a few exact-silhouette pixels, so under 1e-4 of the pixels may differ
by more than 2e-3 in a channel; adapted luminances agree to 1e-5
(relative), since the bands' sums add in another order than one sum over
the image. The port's sharded frames are held to its own single frames
and ``render_adaptive`` chains in that bound (the frame, map and exposure
tests hold those to the JAX package), and to one JAX sharded call (the
XLA rasterizer, eye adaptation on).

That call is jitted, and jitted XLA contracts the setup's products into
FMAs (ROADMAP.md section C): in this configuration the JAX package's own
jitted frame differs from its op-by-op frame at 0.19% of the pixels (a
ridge line of silhouette pixels) and in adapted luminance by 3.2e-5
(relative), while the port's frame equals the op-by-op one (every prim id,
ldr within 6e-5). ``python tests/test_torch_sharded.py`` measures that
(about six minutes). Against the JAX call the frames are therefore held to
tests/test_torch_frame.py's bound against jitted JAX frames (mean ldr
difference below 5e-4) with at most 2.5e-3 of the pixels over 2e-3, and
the adapted luminances to 5e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import t
from vrenderer_tpu_torch import convert, entry
from vrenderer_tpu_torch.camera import Camera
from vrenderer_tpu_torch.ops import raster
from vrenderer_tpu_torch.parallel import sharded
from vrenderer_tpu_torch.renderer import FrameParams, Renderer

W, H = 256, 512
N_FRAMES = 2
DT = 0.1
CUBE_AT = [0.0, 6.0, 10.0]
CPU8 = [torch.device("cpu")] * 8
PIXEL_TOL, PIXEL_SHARE = 2e-3, 1e-4   # tests/test_sharded.py:46-52
LUM_RTOL = 1e-5
# against the jitted JAX call (module docstring)
JIT_MEAN, JIT_SHARE, JIT_LUM_RTOL = 5e-4, 2.5e-3, 5e-5


def _jax_cfg(**kw):
    from vrenderer_tpu.config import FrameConfig, TerrainSettings

    return FrameConfig(width=W, height=H, terrain=TerrainSettings(
        surface_size=64, world_size=64, max_instances=64, grid_size=8), **kw)


def _cameras_np(n, shift=0.0):
    """tests/test_sharded.py's cameras, eyes moved by ``shift``."""
    s = np.linspace(0.0, 1.0, n, dtype=np.float32)
    eye = np.stack([s * 5.0, 25.0 + s * 3, 45.0 - s * 5], axis=-1) + shift
    return (eye.astype(np.float32), np.zeros((n, 3), np.float32),
            np.tile(np.array([0.0, 1.0, 0.0], np.float32), (n, 1)))


def _cameras(n, shift=0.0):
    return Camera(*(t(a) for a in _cameras_np(n, shift)))


def _jax_scene():
    from vrenderer_tpu.models import mesh as jmesh
    from vrenderer_tpu.models import scene as jscene
    from vrenderer_tpu.utils import math3d as jm3

    return jscene.Scene(instances=[jscene.MeshInstance(
        mesh=jmesh.cube(8.0, color=(0.9, 0.05, 0.05)),
        transform=jm3.affine_translation(jnp.asarray(CUBE_AT, jnp.float32)))])


def _params(**kw):
    p = FrameParams.default(device="cpu")._replace(
        max_height=torch.tensor(12.0))
    return p._replace(**{k: torch.tensor(v) for k, v in kw.items()})


def _renderer(backend="pallas", **cfg_kw):
    """The port's renderer on the JAX package's numpy state."""
    from vrenderer_tpu.terrain import heightmap as jh

    hm = jh.procedural_heightmap(64, seed=3)
    js = _jax_scene()
    scene = convert.scene([
        {**{k: np.asarray(v) for k, v in i.mesh._asdict().items()},
         "transform": np.asarray(i.transform)} for i in js.instances])
    cfg = convert.frame_config(dataclasses.asdict(_jax_cfg(**cfg_kw)))
    return Renderer(cfg, t(hm), t(jh.procedural_albedo(hm)), scene=scene,
                    raster_backend=backend, device="cpu")


def _pixel_diff(frame, ref):
    return np.abs(np.asarray(frame) - np.asarray(ref)).max(axis=-1)


def _assert_close_frames(frames, refs):
    """The band bound."""
    for i, (f, ref) in enumerate(zip(frames, refs)):
        share = (_pixel_diff(f, ref) > PIXEL_TOL).mean()
        assert share < PIXEL_SHARE, f"frame {i}: {share:.2e} of pixels differ"


@pytest.fixture(scope="module")
def jax_sharded():
    """One JAX sharded call as tests/test_sharded.py makes it: (frames,
    overflow, adapted) as numpy arrays."""
    from vrenderer_tpu.camera import Camera as JCamera
    from vrenderer_tpu.parallel import sharded as jsharded
    from vrenderer_tpu.renderer import FrameParams as JFrameParams
    from vrenderer_tpu.renderer import Renderer as JRenderer
    from vrenderer_tpu.terrain import heightmap as jh

    hm = jh.procedural_heightmap(64, seed=3)
    r = JRenderer(_jax_cfg(), hm, jh.procedural_albedo(hm),
                  raster_backend="xla", scene=_jax_scene())
    params = JFrameParams.default()._replace(max_height=jnp.float32(12.0))
    cams = JCamera(*(jnp.asarray(a) for a in _cameras_np(N_FRAMES)))
    out = jsharded.render_frames_sharded(
        r, cams, params, jsharded.make_mesh(8, frame_axis=2),
        adapted_lum=0.5, dt=DT, return_aux=True)
    return tuple(np.asarray(a) for a in out)


@pytest.fixture(scope="module")
def port_renderers():
    return {"pallas": _renderer("pallas"), "xla": _renderer("xla")}


@pytest.mark.parametrize("shifter", ["setup", "components"])
def test_shifts_match_jax(shifter):
    """``shift_setup_y`` and ``shift_components_y``: bit for bit the JAX
    package's on the same float32 numpy setup."""
    from vrenderer_tpu.ops import raster as jraster

    rng = np.random.default_rng(5)
    y0 = np.float32(384.0)

    def f32(*shape):
        return (rng.standard_normal(shape) * 300.0).astype(np.float32)

    if shifter == "setup":
        arrs = [f32(40, 3, 3), f32(40, 10, 3), f32(40, 4),
                rng.random(40) < 0.7]
        got = raster.shift_setup_y(raster.TriSetup(*(t(a) for a in arrs)),
                                   float(y0))
        want = jraster.shift_setup_y(
            jraster.TriSetup(*(jnp.asarray(a) for a in arrs)), y0)
        pairs = zip(got, want)
    else:
        maps = [f32(3, 6) for _ in range(9 + 3 * 4 + 4 + 4)]
        valid = rng.random((3, 6)) < 0.7

        def comp(mod, conv):
            m = [conv(a) for a in maps]
            return mod.TriComponents(
                edge=tuple(m[:9]),
                quant=tuple(tuple(m[9 + 3 * k:12 + 3 * k]) for k in range(4)),
                bbox=tuple(m[21:25]), valid=conv(valid),
                vert_clip=tuple(m[25:29]))

        got = raster.shift_components_y(comp(raster, t), float(y0))
        want = jraster.shift_components_y(comp(jraster, jnp.asarray), y0)
        flat = [list(got.edge), [c for q in got.quant for c in q],
                list(got.bbox), [got.valid], list(got.vert_clip)]
        wflat = [list(want.edge), [c for q in want.quant for c in q],
                 list(want.bbox), [want.valid], list(want.vert_clip)]
        pairs = zip(sum(flat, []), sum(wflat, []))
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_mesh_shapes_and_band_height():
    r = _renderer()
    assert sharded.make_mesh(CPU8, frame_axis=2).shape == {"frame": 2,
                                                           "tile": 4}
    assert sharded.make_mesh(CPU8).shape == {"frame": 1, "tile": 8}
    assert sharded.make_mesh(CPU8, n_devices=3).shape == {"frame": 1,
                                                          "tile": 3}
    assert sharded.band_height(r, sharded.make_mesh(CPU8, frame_axis=2)) \
        == 128
    with pytest.raises(ValueError, match="frame_axis"):
        sharded.make_mesh(CPU8, n_devices=6, frame_axis=4)
    with pytest.raises(ValueError, match="whole supertile rows"):
        sharded.band_height(r, sharded.make_mesh(CPU8, n_devices=3))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_sharded_frames_match_jax(jax_sharded, port_renderers, backend):
    """Both of the port's backends over the (2, 4) mesh with adaptation:
    each frame row chains its own chunk from 0.5, so each frame equals a
    one-frame ``render_adaptive`` chain in the band bound; every band
    holds its frame's luminance; and the whole agrees with the JAX
    package's sharded call (module docstring)."""
    r = port_renderers[backend]
    cams, params = _cameras(N_FRAMES), _params()
    frames, ovf, adapted = sharded.render_frames_sharded(
        r, cams, params, sharded.make_mesh(CPU8, frame_axis=2),
        adapted_lum=0.5, dt=DT, return_aux=True)
    assert tuple(frames.shape) == (N_FRAMES, H, W, 3)
    assert tuple(adapted.shape) == tuple(ovf.shape) == (N_FRAMES, 4)
    assert not ovf.any()
    assert (adapted == adapted[:, :1]).all()
    chain = [r.render_adaptive(cams.frame(i), params, 0.5, DT)
             for i in range(N_FRAMES)]
    _assert_close_frames(frames, [o.ldr for o, _ in chain])
    np.testing.assert_allclose(adapted[:, 0].numpy(),
                               [float(lum) for _, lum in chain],
                               rtol=LUM_RTOL)

    j_frames, j_ovf, j_adapted = jax_sharded
    np.testing.assert_array_equal(ovf.numpy(), j_ovf)
    np.testing.assert_allclose(adapted.numpy(), j_adapted,
                               rtol=JIT_LUM_RTOL)
    for i in range(N_FRAMES):
        d = _pixel_diff(frames[i], j_frames[i])
        assert d.mean() < JIT_MEAN
        assert (d > PIXEL_TOL).mean() <= JIT_SHARE


CASES = {
    # (renderer config, frame params, camera shift)
    "map": ({"shadow_mode": "map", "shadow_resolution": 128}, {}, 0.0),
    # a second call on the default renderer, with new cameras
    "gates": ({}, {"render_terrain": 0.0, "debug_quadtree": 1.0}, 1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_frames_match_single(port_renderers, case):
    """Map mode and the params gates: the sharded frames against the
    port's own single frames, in the band bound. "gates" renders on the
    renderer that the JAX comparison rendered with before (a second call
    with new cameras), so stale state would show."""
    cfg_kw, gate_kw, shift = CASES[case]
    r = _renderer(**cfg_kw) if cfg_kw else port_renderers["pallas"]
    params = _params(**gate_kw)
    cams = _cameras(N_FRAMES, shift)
    frames = sharded.render_frames_sharded(
        r, cams, params, sharded.make_mesh(CPU8, frame_axis=2))
    singles = [r.render(cams.frame(i), params).ldr for i in range(N_FRAMES)]
    _assert_close_frames(frames, singles)
    if case == "gates":
        # render_terrain 0: every row is smooth sky
        assert frames[0].std(dim=1).mean() < 0.1


def test_band_replicas_on_another_device():
    """Bands on a device other than the renderer's render with a copy of
    its state, built once and dropped by ``reload_pipelines``; the
    frames equal those rendered on the renderer itself, bit for bit."""
    r = _renderer()
    cams, params = _cameras(1), _params()
    other = torch.device("cpu", 0)     # a CPU device that is not "cpu"
    mesh = sharded.make_mesh([torch.device("cpu"), other])
    assert sharded.band_height(r, mesh) == 256
    a = sharded.render_frames_sharded(r, cams, params, mesh)
    (rep,) = r._band_replicas.values()
    assert rep is not r and rep.device == other
    b = sharded.render_frames_sharded(r, cams, params,
                                      sharded.make_mesh([r.device] * 2))
    assert torch.equal(a, b)
    assert r._band_replicas == {other: rep}
    r.reload_pipelines()
    assert r._band_replicas == {}


def test_dryrun_multichip_cpu():
    entry.dryrun_multichip(8, device="cpu")


if __name__ == "__main__":
    # The JAX package's jitted frame against its op-by-op frame and the
    # port's, at the first camera of the JAX comparison (module docstring)
    import sys

    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import conftest  # noqa: F401  (JAX on the CPU, as the tests run it)
    import jax
    from vrenderer_tpu.camera import Camera as JCamera
    from vrenderer_tpu.renderer import FrameParams as JFrameParams
    from vrenderer_tpu.renderer import Renderer as JRenderer
    from vrenderer_tpu.terrain import heightmap as jh

    hm = jh.procedural_heightmap(64, seed=3)
    jr = JRenderer(_jax_cfg(), hm, jh.procedural_albedo(hm),
                   raster_backend="xla", scene=_jax_scene())
    jp = JFrameParams.default()._replace(max_height=jnp.float32(12.0))
    jcam = JCamera(*(jnp.asarray(a[0]) for a in _cameras_np(N_FRAMES)))
    lum0, dt = jnp.float32(0.5), jnp.float32(DT)
    jit_out, jit_lum = jr.render_adaptive(jcam, jp, 0.5, DT)
    with jax.disable_jit():
        eager_out, eager_lum = jr._frame_impl(
            jcam, jp, None, adapt=(lum0, dt), scene_xf=jr.scene_transforms)
    out, lum = _renderer().render_adaptive(_cameras(N_FRAMES).frame(0),
                                           _params(), 0.5, DT)
    for name, (a, a_lum), (b, b_lum) in (
            ("JAX jitted vs op-by-op", (jit_out, jit_lum),
             (eager_out, eager_lum)),
            ("port vs JAX op-by-op", (out, lum), (eager_out, eager_lum))):
        d = _pixel_diff(a.ldr, b.ldr)
        same = (np.asarray(a.prim_id) == np.asarray(b.prim_id)).mean()
        print(f"{name}: prim ids equal {same:.6f}, pixels over {PIXEL_TOL} "
              f"{(d > PIXEL_TOL).mean():.3g}, mean {d.mean():.3g}, max "
              f"{d.max():.3g}; adapted luminance relative difference "
              f"{abs(float(a_lum) / float(b_lum) - 1.0):.3g}")
