"""The Renderer's ``raster_backend`` and ``interpret`` arguments: the
port's "xla" backend (the dense oracle ``raster.rasterize_xla`` for the
main and light rasters) against the JAX package's "xla" frames, in both
shadow modes with a loaded glTF scene, and against the port's own
"pallas" backend (the kernels' plain versions on the CPU).

The JAX map frame and the port's take the same light pass, which is
ill-conditioned (tests/test_torch_map_frame.py); tests/test_torch_editor.py
holds the horizon frames with a loaded scene. Frames are held to
tests/test_torch_frame.py's bounds; the two port backends to the ROADMAP
parity bar (ids exact, depth 1e-6, attrs 3e-4)."""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import write_scene_glb
from torch_parity import JCFG, cameras, frame_params_pair
from vrenderer_tpu.models import scene as jscene
from vrenderer_tpu.renderer import Renderer as JRenderer
from vrenderer_tpu.terrain import heightmap as jhmod
from vrenderer_tpu_torch import convert
from vrenderer_tpu_torch.app import App
from vrenderer_tpu_torch.models import scene as pscene
from vrenderer_tpu_torch.renderer import Renderer

VIEW = ([0.0, 25.0, 45.0], [0.0, 8.0, 0.0])


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("xla") / "scene.glb")
    write_scene_glb(path, tex_size=16, quad_size=20.0,
                    center=(0.0, 14.0, 0.0), root_yaw=0.0)
    return path


def _pair(scene_path, mode, backend="xla"):
    jcfg = dataclasses.replace(JCFG, shadow_mode=mode, shadow_resolution=128)
    hm = jhmod.procedural_heightmap(64, seed=7)
    alb = jhmod.procedural_albedo(hm)
    jr = JRenderer(jcfg, hm, alb, raster_backend="xla",
                   scene=jscene.load_gltf(scene_path))
    r = Renderer(convert.frame_config(dataclasses.asdict(jcfg)),
                 convert.tensor(np.asarray(hm)),
                 convert.tensor(np.asarray(alb)), raster_backend=backend,
                 scene=pscene.load_gltf(scene_path, device="cpu"),
                 device="cpu")
    return jr, r


def test_xla_backend_map_frame_matches_jax(scene_path):
    """Map mode with the loaded scene through the same light pass (horizon
    frames with a loaded scene: tests/test_torch_editor.py)."""
    import jax

    jr, r = _pair(scene_path, "map")
    jcam, cam = cameras(*VIEW)
    jp, p = frame_params_pair()
    jpre = jax.jit(jr._light_depth_pass)(
        jp, jcam.eye, jr._scene_blocks(jr.scene_transforms, jp.max_height))
    z, wtc, z_range, ovf, shear = jpre
    pre = convert.shadow_prepass(np.asarray(z), np.asarray(wtc), z_range,
                                 np.asarray(ovf),
                                 [np.asarray(v) for v in shear])
    jout = jr.render(jcam, jp, shadow_prepass=jpre)
    out = r.render(cam, p, shadow_prepass=pre)
    n_terrain = JCFG.terrain.max_instances * JCFG.terrain.tris_per_instance
    prim = out.prim_id.numpy()
    assert int((prim >= n_terrain).sum()) > 50
    same = prim == np.asarray(jout.prim_id)
    assert same.mean() >= 0.999
    d = np.abs(out.ldr.numpy() - np.asarray(jout.ldr))
    assert d.mean() < 5e-4 and d[same].max() < 5e-3
    for f in ("num_instances", "num_selected", "num_work_items",
              "overflow_mask"):
        assert int(getattr(out, f)) == int(getattr(jout, f)), f
    assert int(out.num_work_items) == 0


@pytest.mark.parametrize("mode", ["horizon", "map"])
def test_xla_and_pallas_backends_agree(scene_path, mode):
    """The same frame through the dense oracle and through the binned
    raster (B1's plain version; B2's in map mode): prim ids exact, depth
    and the light map bitwise, attributes within 3e-4; only the pallas
    backend counts work items."""
    _, rx = _pair(scene_path, mode)
    _, rp = _pair(scene_path, mode, backend="pallas")
    _, cam = cameras(*VIEW)
    _, p = frame_params_pair()
    vc = rx._view(cam)
    with torch.no_grad():
        outs = []
        for r in (rx, rp):
            sh = r._shadow_inputs(vc, p)
            outs.append(r._terrain_pass(vc, p, sh))
        zx, idx, atx, _, nx = outs[0]
        zp, idp, atp, _, npw = outs[1]
        assert torch.equal(idx, idp)
        cov = idx >= 0
        assert torch.equal(zx[cov], zp[cov])
        assert float((atx - atp).abs()[cov].max()) <= 3e-4
        assert int(nx) == 0 < int(npw)
        if mode == "map":
            lx = rx.render_shadow_depth(p)
            lp = rp.render_shadow_depth(p)
            assert torch.equal(lx, lp) and bool((lx < 2.0).any())
        fx, fp = rx.render(cam, p), rp.render(cam, p)
        assert torch.equal(fx.prim_id, fp.prim_id)
        assert float((fx.ldr - fp.ldr).abs().max()) < 5e-3


def test_backend_arguments():
    """Unknown backends raise; interpret=True raises on the CUDA device
    (the port has no interpreter and never runs the plain versions there
    in its place; no card is needed to see it) and changes nothing on the
    CPU; the App passes its raster_backend to the Renderer."""
    hm = torch.zeros((8, 8))
    cfg = convert.frame_config(dataclasses.asdict(JCFG))
    with pytest.raises(ValueError, match="raster_backend"):
        Renderer(cfg, hm, None, raster_backend="mosaic", device="cpu")
    with pytest.raises(ValueError, match='device="cpu"'):
        Renderer(cfg, hm, None, interpret=True, device="cuda")
    _, cam = cameras(*VIEW)
    _, p = frame_params_pair()
    a = Renderer(cfg, hm, None, interpret=True, device="cpu")
    b = Renderer(cfg, hm, None, device="cpu")
    assert a.interpret and not b.interpret and b.raster_backend == "pallas"
    assert torch.equal(a.render(cam, p).ldr, b.render(cam, p).ldr)
    app = App(cfg, heightmap_resolution=16, raster_backend="xla",
              device="cpu")
    assert app.renderer.raster_backend == "xla"
    assert app.renderer.debug_selection(cam).selected.any()
