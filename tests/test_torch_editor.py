"""The Editor of vrenderer_tpu_torch against vrenderer_tpu's on the CPU:
the command sequences of tests/test_editor_shell.py,
tests/test_editor_features.py and tests/test_scene_transforms.py:103 run
through both Editors (the "xla" backend, 256x128, a 64 m world, a 128^2
light map), with a glTF scene written by chip_smoke.write_scene_glb.

Eye adaptation steps by the wall time between renders, so the compared
frames render with ``adapt off``; adaptation itself is checked on the port
alone. Frames are held to tests/test_torch_frame.py's bounds (the jitted
JAX frame moves a few silhouette pixels: prim ids equal at >= 99.9% of
pixels, ldr mean < 5e-4 and max < 5e-3 where the owner agrees); ``stats``
counts equal; ``reload`` renders bit-identically."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import write_scene_glb
from vrenderer_tpu.app import App as JApp
from vrenderer_tpu.config import FrameConfig as JFrameConfig
from vrenderer_tpu.config import TerrainSettings as JTerrainSettings
from vrenderer_tpu.editor import Editor as JEditor
from vrenderer_tpu_torch import convert
from vrenderer_tpu_torch.app import App
from vrenderer_tpu_torch.editor import Editor
from vrenderer_tpu_torch.renderer import Renderer

JCFG = JFrameConfig(width=256, height=128, shadow_resolution=128,
                    terrain=JTerrainSettings(surface_size=64, world_size=64,
                                             max_instances=64, grid_size=8))
CFG = convert.frame_config(dataclasses.asdict(JCFG))
N_TERRAIN = 64 * CFG.terrain.tris_per_instance

# (name of the frame it renders or None, command, run by JAX's Editor
# too); "{glb}" and "{tmp}" are filled in. JAX's dense oracle takes 2.5 s
# a frame here and its lock-view 14 s to compile, so the JAX Editor skips
# the frames of the parameter controls, lock-view, move-instance and the
# moving cameras (whose poses are compared), which the port checks
# against its own Renderer (test_editor_effects); the loaded scene's first
# frame is compared
SCRIPT = [
    (None, "adapt off", True),
    (None, "camera 0 25 45  0 0 0", True),
    (None, "max-height 12", True),
    ("plain", "render", False),
    (None, "stats", False),
    (None, "light 45 30", True),
    (None, "ambient 0.3", True),
    (None, "exposure 1.5", True),
    ("lit", "render", False),
    (None, "terrain off", True),
    ("sky", "render", False),
    (None, "terrain on", True),
    (None, "debug-quadtree on", True),
    ("debug", "render", False),
    (None, "debug-quadtree off", True),
    (None, "lock", False),
    (None, "camera 30 25 45  0 0 0", True),
    ("locked", "render", False),
    (None, "unlock", False),
    (None, "load {glb}", True),
    (None, "camera 0 25 45  0 0 0", True),
    ("scene", "render", True),
    (None, "stats", True),
    (None, "move-instance 0 6 0 0", True),
    ("moved", "render", False),
    (None, "walk on", True),
    (None, "step 0.1 w 5 0", True),
    (None, "step 0.1 W", True),
    (None, "step 0.1 wd -3 2", True),
    ("walk", "render", False),
    (None, "orbit on", True),
    (None, "drag 30 10", True),
    (None, "zoom 0.8", True),
    ("orbit", "render", False),
    (None, "shadow-depth {tmp}/shadow.png", False),
]
COMPARED = [n for n, _, both in SCRIPT if n is not None and both]


def _feed_eager_prepass(jr):
    """Make the JAX renderer's frames take its horizon prepass computed
    eagerly (each operation on its own, as ``jax.disable_jit()`` runs it;
    the same arrays, the mesh-top raster's own jit aside).

    With scene occluders, JAX's prepass jitted as one computation differs
    from its own eager one (XLA fuses the transform, setup and march
    products): here by 1.0 at 24 shadow-field texels and 1.018 at 681
    shadow-line texels, while the port equals the eager fields exactly
    (test_editor_horizon_prepass_matches_jax_eager, ROADMAP C; the
    differences were measured by a one-off script, not kept). Frames with
    a prepass equal frames without in both packages."""
    render = jr.render

    def render_eager_prepass(camera, params=None, shadow_prepass=None):
        pre = jr._horizon_fields(params, jr.scene_transforms)
        return render(camera, params, shadow_prepass=pre)

    jr.render = render_eager_prepass


def _run(ed, tmp, glb, jax_side=False):
    """Run SCRIPT (JAX's share with ``jax_side``): (responses by script
    index, frames by name, eyes after each step)."""
    responses, frames, eyes = {}, {}, []
    for k, (name, line, both) in enumerate(SCRIPT):
        if jax_side and not both:
            continue
        if jax_side and line == "render" and ed.app.renderer.scene_transforms \
                is not None:
            _feed_eager_prepass(ed.app.renderer)
        resp = ed.execute(line.format(glb=glb, tmp=tmp))
        responses[k] = resp
        assert not resp.startswith("error") and "unknown" not in resp, \
            (line, resp)
        if name is not None:
            frames[name] = ed.last_output
        if line.startswith("step"):
            eyes.append(np.asarray(ed.camera.eye))
    return responses, frames, eyes


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("editor")
    glb = str(tmp / "scene.glb")
    # an unrotated root keeps the pillar's vertical faces exactly
    # degenerate in the top-down mesh-top raster; rotated, they are
    # slivers whose depth planes are ill-conditioned (ROADMAP C; the
    # witness is test_mesh_top_field_slivers_are_ill_conditioned in
    # tests/test_torch_scene.py)
    write_scene_glb(glb, tex_size=16, quad_size=20.0, center=(0.0, 14.0, 0.0),
                    root_yaw=0.0)
    jed = JEditor(JApp(JCFG, heightmap_resolution=64, raster_backend="xla"),
                  out_dir=str(tmp / "jax"))
    ed = Editor(App(CFG, heightmap_resolution=64, raster_backend="xla",
                    device="cpu"), out_dir=str(tmp / "port"))
    port = _run(ed, tmp / "port", glb)
    jax_run = _run(jed, tmp / "jax", glb, jax_side=True)
    return ed, jed, port, jax_run, tmp, glb


def assert_frames_close(out, jout):
    same = out.prim_id.numpy() == np.asarray(jout.prim_id)
    assert same.mean() >= 0.999
    d = np.abs(out.ldr.numpy() - np.asarray(jout.ldr))
    assert d.mean() < 5e-4
    assert d[same].max() < 5e-3
    for f in ("num_instances", "num_selected", "num_work_items",
              "overflow_mask"):
        assert int(getattr(out, f)) == int(getattr(jout, f)), f


@pytest.mark.parametrize("frame", COMPARED)
def test_editor_frames_match_jax(session, frame):
    _, _, port, jax_run, _, _ = session
    out, jout = port[1][frame], jax_run[1][frame]
    assert_frames_close(out, jout)
    assert bool(torch.isfinite(out.ldr).all())
    assert int(out.num_work_items) == 0          # the dense oracle's count
    assert 0.0 < float((out.prim_id >= 0).float().mean()) < 1.0
    assert int((out.prim_id >= N_TERRAIN).sum()) > 50


def test_editor_responses_match_jax(session):
    """The responses of both Editors to the commands they both ran name the
    same numbers: stats, render's instances and work, load's instance
    count, move-instance's new origin, the walk steps' eye, speed and
    look, orbit's pivot and distance."""
    _, _, port, jax_run, _, _ = session
    for k, b in jax_run[0].items():
        a, line = port[0][k], SCRIPT[k][1]
        na = re.findall(r"-?\d+\.?\d*", a.split(".png")[-1])
        nb = re.findall(r"-?\d+\.?\d*", b.split(".png")[-1])
        assert len(na) == len(nb), (line, a, b)
        np.testing.assert_allclose(np.float64(na), np.float64(nb),
                                   atol=0.011, err_msg=f"{line}: {a} / {b}")
    assert "3 instance(s)" in port[0][SCRIPT.index(
        (None, "load {glb}", True))]


def test_editor_horizon_prepass_matches_jax_eager(session):
    """With the scene loaded (and moved), the port's horizon fields
    (mesh-top raster, march, shadow line) equal JAX's eager fields
    exactly (JAX's fields jitted as one computation differ from both at
    tie texels; see _feed_eager_prepass)."""
    ed, jed, _, _, _, _ = session
    r, jr = ed.app.renderer, jed.app.renderer
    want = jr._horizon_fields(jed.app.params, jr.scene_transforms)
    got = r.horizon_shadow_prepass(ed.app.params)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_editor_cameras_match_jax(session):
    """The walk steps' eyes (first-person controller) and the orbit
    camera."""
    ed, jed, port, jax_run, _, _ = session
    np.testing.assert_allclose(np.stack(port[2]), np.stack(jax_run[2]),
                               atol=1e-4)
    for f in ("eye", "target"):
        np.testing.assert_allclose(getattr(ed.camera, f).numpy(),
                                   np.asarray(getattr(jed.camera, f)),
                                   atol=1e-4)


def test_editor_effects(session):
    """The port's frames of the parameter controls and lock-view, against
    its own Renderer: light, ambient and exposure move the frame;
    terrain off leaves the sky (depth 1 everywhere); debug-quadtree tints
    covered pixels only; the locked frame is render_locked with the
    selection of the camera it locked at, and differs from the live
    selection's; move-instance moved the scene's pixels in place; the
    parameters live on the App's device."""
    ed, _, port, _, _, _ = session
    fr = port[1]
    assert (fr["lit"].ldr - fr["plain"].ldr).abs().max() > 0.05
    assert bool((fr["sky"].depth == 1.0).all())
    cov = fr["lit"].prim_id >= 0
    d = (fr["debug"].ldr - fr["lit"].ldr).abs().sum(-1)
    assert float(d[cov].mean()) > 0.05 and float(d[~cov].max()) < 1e-6

    no_scene = Renderer(CFG, ed.app.heightmap, ed.app.albedo,
                        raster_backend="xla", device="cpu")
    cam0 = convert.camera([0, 25, 45], [0, 0, 0], [0, 1, 0])
    cam1 = convert.camera([30, 25, 45], [0, 0, 0], [0, 1, 0])
    params = ed.app.params      # no control changed them after the lock
    locked = no_scene.render_locked(cam1, params, no_scene.select(cam0))
    for f in ("ldr", "depth", "prim_id", "num_instances"):
        assert torch.equal(getattr(fr["locked"], f), getattr(locked, f)), f
    assert int(locked.num_instances) == int(fr["lit"].num_instances)
    live = no_scene.render(cam1, params)
    assert not torch.equal(live.prim_id, locked.prim_id)

    moved = ((fr["scene"].prim_id >= N_TERRAIN)
             != (fr["moved"].prim_id >= N_TERRAIN))
    assert int(moved.sum()) > 20
    r = ed.app.renderer
    assert r.raster_backend == "xla" and r.device.type == "cpu"
    np.testing.assert_allclose(r.scene_transforms[0, 3].numpy(),
                               [6.0, 14.0, 0.0], atol=1e-5)
    for v in params:
        assert v.device.type == "cpu"


def test_editor_shadow_depth(session):
    """shadow-depth writes the light pass from the default eye (the dense
    oracle here, B2's plain version under "pallas"; the light pass itself
    is held to JAX's in tests/test_torch_map_frame.py) as an 8-bit gray
    image: far texels white, covered ones their z."""
    from vrenderer_tpu_torch.app import write_png
    from vrenderer_tpu_torch.terrain.heightmap import load_png

    ed, _, _, _, tmp, _ = session
    a = load_png(str(tmp / "port" / "shadow.png")).numpy()
    z = ed.app.renderer.render_shadow_depth(ed.app.params)
    z01 = torch.clamp(torch.where(z > 1e30, torch.ones_like(z), z), 0.0, 1.0)
    write_png(str(tmp / "ref.png"), z01[..., None].expand(-1, -1, 3).numpy())
    assert a.shape == (128, 128, 3) and 0.0 < (a < 1.0).mean() < 1.0
    np.testing.assert_array_equal(a, load_png(str(tmp / "ref.png")).numpy())


def test_editor_reload_renders_bit_identically(session):
    """reload drops the cached prepasses; the next frame equals the frame
    before it, and a cached horizon prepass is recomputed equal."""
    ed, _, _, _, _, _ = session
    r = ed.app.renderer
    before = ed._render()
    pre = r.cached_horizon_prepass(ed.app.params)
    assert "dropped" in ed.execute("reload")
    assert r._horizon_prepass_cache is None
    after = ed._render()
    for f in ("ldr", "hdr", "depth", "prim_id", "overflow_mask"):
        assert torch.equal(getattr(before, f), getattr(after, f)), f
    pre2 = r.cached_horizon_prepass(ed.app.params)
    assert pre2 is not pre
    assert all(torch.equal(x, y) for x, y in zip(pre, pre2))


def test_editor_shell_commands(session):
    """The rest of the surface on the port: fly, fps, the exports, help,
    speed, orbit/walk off, an unknown command and an error, adaptation,
    clear-scene (a Renderer without the scene, same backend and device)."""
    ed, _, _, _, tmp, glb = session
    # the App's flythrough flies at 205 m, where this 64 m world selects
    # more than the 64-instance budget
    with pytest.warns(UserWarning, match="render budget"):
        resp = ed.execute("fly 2")
    assert resp.startswith("rendered 2 frames")
    assert os.path.exists(os.path.join(ed.out_dir, "frame_0001.png"))
    fps = ed.execute("fps")
    assert "ms/frame" in fps and "FPS" in fps
    svg = ed.execute("flamegraph").split()[-1]
    assert open(svg).read().startswith("<svg")
    assert os.path.getsize(ed.execute("trace").split()[-1]) > 50
    assert "load PATH" in ed.execute("help")
    assert "unknown" in ed.execute("frobnicate")
    assert ed.execute("move-instance 9 1 1 1").startswith("error")
    assert ed.execute("load /nonexistent.glb").startswith("error")
    assert "no first-person" in ed.execute("speed 3")
    assert "no orbit" in ed.execute("orbit off") + ed.execute("drag 1 1")
    ed.execute("walk fly")
    assert ed.execute("speed 5") == "ok" and ed.fpc.move_speed == 5.0
    ed.execute("walk off")

    ed.execute("adapt on")
    lum0 = ed.adapted_lum
    ed._render()
    ed._render()
    assert np.isfinite(ed.adapted_lum) and ed.adapted_lum != lum0
    ed.execute("adapt off")

    ed.execute("camera 0 25 45  0 0 0")
    with_scene = ed._render()
    assert int((with_scene.prim_id >= N_TERRAIN).sum()) > 0
    ed.execute("clear-scene")
    r = ed.app.renderer
    assert r.scene_transforms is None and r.raster_backend == "xla"
    out = ed._render()
    assert int(out.prim_id.max()) < N_TERRAIN
    assert "no scene" in ed.execute("move-instance 0 1 0 0")
    ref = Renderer(CFG, ed.app.heightmap, ed.app.albedo,
                   raster_backend="xla", device="cpu")
    assert torch.equal(ref.render(ed.camera, ed.app.params).ldr, out.ldr)


def test_editor_defaults(tmp_path):
    """Without an App the Editor builds the JAX package's default (512x256,
    max_instances 1024) on the CUDA device, which raises here; with
    device="cpu" it builds on the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            Editor(out_dir=str(tmp_path))
    ed = Editor(out_dir=str(tmp_path), device="cpu")
    cfg = ed.app.config
    assert (cfg.width, cfg.height, cfg.terrain.max_instances) == (512, 256,
                                                                   1024)
    assert ed.app.device.type == "cpu" and ed.camera.eye.device.type == "cpu"
    assert ed.app.renderer.raster_backend == "pallas"


def test_entry_and_examples_on_cpu(tmp_path):
    """entry(device="cpu") renders one finite frame at the JAX entry's CPU
    size; hello_triangle goes through raster_cuda.rasterize (B1's plain
    version here) and colours its covered pixels; the walkthrough walks
    and writes its PNGs."""
    from vrenderer_tpu_torch.entry import entry
    from vrenderer_tpu_torch.examples.hello_triangle import render_triangle
    from vrenderer_tpu_torch.examples.walkthrough import walk
    from vrenderer_tpu_torch.ops import raster_cuda

    fn, args = entry(device="cpu")
    ldr = fn(*args)
    assert ldr.shape == (128, 256, 3) and bool(torch.isfinite(ldr).all())
    calls = []
    plain = raster_cuda.rasterize_plain

    def spy(*a, **k):
        calls.append(a[2:4])
        return plain(*a, **k)

    raster_cuda.rasterize_plain = spy
    try:
        rgb, prim = render_triangle(device="cpu")
    finally:
        raster_cuda.rasterize_plain = plain
    assert calls == [(512, 256)]
    cov = prim >= 0
    assert 0.2 < float(cov.float().mean()) < 0.35
    assert float(rgb[cov].sum(-1).min()) > 0.9   # barycentric colours
    app = walk(str(tmp_path), 2, device="cpu")
    assert len(app.profiler.frame_times_ms) == 2
    assert (tmp_path / "walk_0001.png").exists()
