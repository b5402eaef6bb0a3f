"""The port's workload modes (vrenderer_tpu_torch/workloads.py) against the
JAX package's bench (bench.py), on the CPU.

* Each mode's FrameConfig, budgets and cameras equal those of
  ``bench.build()``, which runs with its module globals (MODE, WIDTH,
  HEIGHT, SNAP_QUANT, SHADOW_RES) set as its command line would set them.
  bench.py is loaded as a module with a bare ``sys.argv``; its environment
  defaults and ``sys.path`` entry are undone after the import.
* ``cell_crossings`` against bench's count of light rasters, which its
  ``chain_fn`` prints for the quantized-eye modes.
* ``probe`` and ``steady_frames`` on a small map configuration (the light
  rasters, cached frames bit-identical to inline ones), ``camera_stats``'
  terms.
* The port's LOD selection at full size, every camera of every mode,
  against ``workload_counts_jax.npz``, and the work items of camera 0 where
  the CPU can bin them cheaply.

``workload_counts_jax.npz`` holds, for each variant of VARIANTS (the nine
modes, mapsnap at quant 64 and map at a 1024 light map), the JAX bench's
cameras and, at each camera, the JAX package's ``Renderer.select`` count
(``selected``), the map modes' light-pass selection count
(``light_selected``; the frame of ``map``, which shares the light pass's
geometry, reports that one) and the work items of the main and the light
raster (``work``, ``light_work``), all computed op by op
(``jax.disable_jit()``), as the port computes; the same terms jitted carry
the suffix ``_jit``. XLA's fusion moves JAX's own jitted selection at a
few cameras (flythrough camera 21: 299 instances jitted, 303 op by op and
in the port; ROADMAP.md section C). A full-size Pallas frame in interpret
mode takes minutes on the CPU, so the work items come from the JAX
package's own binning (``_packed_geometry`` and
``raster_pallas.build_work_list``, as ``_terrain_pass`` and
``_light_depth_pass`` call them) on its renderer's geometry
(``vertex.vertex_geometry``): the count its frame reports, since no
attribute moves a bbox. In ``map`` the JAX frame bins the light selection
masked to the main selection's nodes, which is the main selection's work
list in another slot order. chip_smoke.py holds the card's frames to the
op-by-op counts. Rewrite the file with ``python
tests/test_torch_workloads.py --write`` (JAX on the CPU, about half an
hour).
"""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
COUNTS = os.path.join(HERE, "workload_counts_jax.npz")
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from vrenderer_tpu_torch import workloads  # noqa: E402
from vrenderer_tpu_torch.camera import Camera  # noqa: E402
from vrenderer_tpu_torch.config import TerrainSettings  # noqa: E402
from vrenderer_tpu_torch.models.scene import Scene  # noqa: E402
from vrenderer_tpu_torch.renderer import FrameParams, Renderer  # noqa: E402
from vrenderer_tpu_torch.terrain import heightmap as hmod  # noqa: E402

# (name, mode, quant, shadow_res): chip_smoke.py's phase 15 runs the same
VARIANTS = [(m, m, None, None) for m in workloads.MODES] + [
    ("mapsnap-q64", "mapsnap", 64.0, None),
    ("map-r1024", "map", None, 1024),
]
_TRIG = ("1080p", "4k", "map", "mapref", "mapcache", "mapsnap", "envelope")


def load_bench():
    """bench.py as a module, without its command line and with the
    environment and ``sys.path`` as they were."""
    env, path, argv = dict(os.environ), list(sys.path), sys.argv
    sys.argv = [os.path.join(REPO, "bench.py")]
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_bench", os.path.join(REPO, "bench.py"))
        bench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)
    finally:
        sys.argv = argv
        sys.path[:] = path
        os.environ.clear()
        os.environ.update(env)
    return bench


def bench_build(bench, mode, quant=None, shadow_res=None):
    """``bench.build()`` with the globals ``--mode``, ``--quant`` and
    ``--shadowres`` set (bench.py:68-92)."""
    bench.MODE = mode
    bench.SNAP_QUANT = float(workloads.default_quant(mode) if quant is None
                             else quant)
    bench.SHADOW_RES = 2048 if shadow_res is None else int(shadow_res)
    bench.WIDTH, bench.HEIGHT = ((3840, 2176) if mode in ("4k", "envelope")
                                 else (1920, 1152))
    return bench.build()


@pytest.fixture(scope="module")
def bench():
    return load_bench()


@pytest.fixture(scope="module")
def stored():
    with np.load(COUNTS) as f:
        return {k: f[k] for k in f.files}


def _cams_np(cams):
    return [np.asarray(getattr(cams, f), np.float32)
            for f in ("eye", "target", "up")]


@pytest.mark.parametrize("name,mode,quant,res", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_build_matches_bench(bench, name, mode, quant, res):
    """Configuration, budgets and cameras equal bench.build()'s: bit for
    bit where bench builds them in numpy, within an ulp of trig where it
    takes sines in XLA (tests/test_torch_assets.py's flythrough bound)."""
    jr, _, jcams = bench_build(bench, mode, quant, res)
    r, params, cams = workloads.build(mode, device="cpu", quant=quant,
                                      shadow_res=res)
    assert dataclasses.asdict(r.config) == dataclasses.asdict(jr.config)
    assert (r.max_active, r.max_work) == (jr.max_active, jr.max_work)
    assert r.scene_transforms is not None and jr._scene_obj is not None
    assert r._scene_obj.shape == jr._scene_obj.shape
    np.testing.assert_array_equal(r.heightmap.numpy(),
                                  np.asarray(jr.heightmap))
    assert float(params.max_height) == float(workloads.MAX_HEIGHT)
    for got, want in zip(_cams_np(cams), _cams_np(jcams)):
        assert got.shape == want.shape == (workloads.N_CAMERAS, 3)
        if mode in _TRIG:
            np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quant,cams", [(256.0, "mapsnap"), (64.0, "mapsnap"),
                                        (64.0, "mapwalk")])
def test_cell_crossings_match_bench(bench, capsys, quant, cams):
    """One light raster a crossing plus the fill, as bench's chain_fn
    counts them for its scan (bench.py:250-256)."""
    jr, params, jcams = bench_build(bench, cams, quant)
    bench.chain_fn(jr, params, jcams, 4)
    line = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("mapsnap: quant=")][-1]
    n_miss = int(line.split(",")[1].split()[0])
    port = workloads.cameras(cams, hmod.procedural_heightmap(256), 2048)
    assert workloads.cell_crossings(port, quant) + 1 == n_miss
    assert n_miss > 1


def test_build_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        workloads.build("1080p")
    with pytest.raises(ValueError, match="unknown mode"):
        workloads.build("8k", device="cpu")
    with pytest.raises(SystemExit):
        workloads.main(["--mode", "map", "--frames", "0"])


# -- a small map configuration on the CPU ------------------------------------

SMALL_QUANT = 16.0


def _small(mode, max_work=2048):
    """tests/test_torch_map_frame.py's small world (64 m, max_instances 64,
    grid 8, the cube) at 128x64 with a 128^2 light map, in ``mode``'s
    shadow configuration, and 5 cameras 8 m apart looking at the centre,
    which cross SMALL_QUANT cells twice."""
    ts = TerrainSettings(surface_size=64, world_size=64, max_instances=64,
                         grid_size=8)
    cfg = workloads.config(mode, quant=SMALL_QUANT, shadow_res=128)
    cfg = dataclasses.replace(cfg, width=128, height=64, terrain=ts)
    hm = hmod.procedural_heightmap(64, seed=7)
    r = Renderer(cfg, hm, hmod.procedural_albedo(hm), max_work=max_work,
                 scene=Scene.default("cpu"), device="cpu")
    params = FrameParams.default()._replace(max_height=torch.tensor(12.0))
    x = torch.arange(5, dtype=torch.float32) * 8.0 - 20.0
    eye = torch.stack([x, torch.full_like(x, 25.0), torch.full_like(x, 45.0)],
                      -1)
    up = torch.tensor([[0.0, 1.0, 0.0]]).repeat(5, 1)
    return r, params, Camera(eye=eye, target=torch.zeros_like(eye), up=up)


def test_probe_raises_on_overflow_and_a_small_envelope():
    r, params, cams = _small("1080p", max_work=8)
    with pytest.raises(RuntimeError, match="work items"):
        workloads.probe(r, params, cams, "1080p")
    r, params, cams = _small("1080p")
    out = workloads.probe(r, params, cams, "1080p")
    assert 0 < int(out.num_instances) <= workloads.ENVELOPE_MIN_INSTANCES
    with pytest.raises(RuntimeError, match="envelope"):
        workloads.probe(r, params, cams, "envelope")


def test_steady_frames_cache_is_exact():
    """The quantized eye rasters the light view on every cell crossing
    and once to fill, and the cached frames are bit-identical to inline
    ones; camera_stats' terms are those of the frames."""
    mode = "mapsnap"
    r, params, cams = _small(mode)
    n = cams.eye.shape[0]
    crossings = workloads.cell_crossings(cams, SMALL_QUANT)
    assert crossings >= 2
    steady = workloads.steady_frames(r, params, cams, mode, n=n,
                                     keep=range(n))
    assert steady.light_rasters == crossings + 1
    assert steady.ms is None and steady.summary.shape == (
        n, len(workloads.SUMMARY))
    for i in range(n):
        inline = r.render(cams.frame(i), params)
        for f in ("ldr", "hdr", "depth", "prim_id", "overflow_mask",
                  "num_work_items", "num_selected"):
            assert torch.equal(getattr(steady.frames[i], f),
                               getattr(inline, f)), (i, f)
    col = {k: j for j, k in enumerate(workloads.SUMMARY)}
    assert (steady.summary[:, col["finite"]] == 1).all()
    assert (steady.summary[:, col["coverage"]] > 0).all()
    assert (steady.summary[:, col["overflow_mask"]] == 0).all()
    stats = workloads.camera_stats(r, params, cams, mode, steady)
    assert "mean_ms" not in stats and len(stats["cameras"]) == n
    for i, row in enumerate(stats["cameras"]):
        assert row["work_items"] == steady.summary[i, col["num_work_items"]]
        assert row["instances"] == steady.summary[i, col["num_instances"]]
        assert 0 < row["valid_tris"] <= (r.max_active + 1) * 128
        assert row["evaluated_pairs"] > 0


# -- full-size selection against the stored JAX counts ------------------------

@pytest.mark.parametrize("name,mode,quant,res", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_selection_counts_match_jax(stored, name, mode, quant, res):
    """Every camera: the main selection's count (and the light pass's in
    the map modes) equals the JAX package's on its own cameras."""
    r, params, cams = workloads.build(mode, device="cpu", quant=quant,
                                      shadow_res=res)
    for f in ("eye", "target", "up"):
        want = stored[f"{name}:{f}"]
        got = getattr(cams, f).numpy()
        if mode in _TRIG:
            np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    cfg = r.config
    with torch.no_grad():
        sel = [int(r.select(cams.frame(i)).count)
               for i in range(workloads.N_CAMERAS)]
        np.testing.assert_array_equal(sel, stored[f"{name}:selected"])
        if mode in workloads.MAP_MODES:
            from vrenderer_tpu_torch.ops import shadow

            wtc = shadow.sun_shear_matrices(
                params.light_direction, float(cfg.terrain.world_size),
                params.max_height, cfg.shadow_resolution)[0]
            light = [int(r._light_select(params, wtc, cams.eye[i])[0].count)
                     for i in range(workloads.N_CAMERAS)]
            np.testing.assert_array_equal(light,
                                          stored[f"{name}:light_selected"])


@pytest.mark.parametrize("name", ["1080p", "ground", "mapwalk", "envelope"])
def test_work_items_at_camera0_match_jax(stored, name):
    """Camera 0's work list counts what JAX's does: the main raster's in
    horizon modes, the light pass's in mapwalk."""
    r, params, cams = workloads.build(name, device="cpu")
    cam = cams.frame(0)
    if name == "mapwalk":
        _, work = r.light_raster_inputs(cam, params)
        assert int(work.num_items) == int(stored[f"{name}:light_work"][0])
    else:
        _, work = r.raster_inputs(cam, params,
                                  r.cached_horizon_prepass(params))
        assert int(work.num_items) == int(stored[f"{name}:work"][0])


# -- writing workload_counts_jax.npz -----------------------------------------

def _jax_terms(jr, params, jit=True):
    """(eye, target, up) -> (selected, light selected, work items, light
    work items) of the JAX bench renderer ``jr`` (-1 where there is no
    light pass), jitted or op by op."""
    import jax
    import jax.numpy as jnp

    from vrenderer_tpu.camera import Camera as JCamera
    from vrenderer_tpu.camera import make_view_constants
    from vrenderer_tpu.ops import raster_pallas, shadow, vertex
    from vrenderer_tpu.terrain import quadtree
    from vrenderer_tpu.utils import math3d as jmath3d

    cfg = jr.config
    ts = cfg.terrain
    scene_wa = jr._scene_blocks(jr.scene_transforms, params.max_height)

    def work(instances, eye, ranges, wtc, w, h, sub_h):
        geom = vertex.vertex_geometry(ts, instances, eye, jr.heightmap,
                                      params.max_height, ranges)
        attrs = jnp.zeros(geom.world.shape[:3] + (vertex.NUM_ATTRS,),
                          jnp.float32)
        packed, bbox, usable, dist = jr._packed_geometry(
            geom.world, attrs, instances.valid, wtc, w, h, scene_wa=scene_wa)
        return raster_pallas.build_work_list(
            bbox, usable, w, h, tile=cfg.raster.tile_w,
            tris_per_inst=ts.tris_per_instance, max_work=jr.max_work,
            order_key=dist, packed=packed, sub_h=sub_h,
            compact_k=cfg.raster.compact_k, win_w=cfg.raster.win_w,
        ).num_items

    def terms(eye, target, up):
        cam = JCamera(eye=eye, target=target, up=up)
        vc = make_view_constants(cam, cfg.width, cfg.height,
                                 cfg.vfov_degrees, cfg.z_near, cfg.z_far)
        planes = jmath3d.frustum_planes(vc["world_to_clip"])
        sel = quadtree.select_all_surfaces(ts, vc["camera_pos"], planes,
                                           ts.lod_ranges())
        n_work = work(jr._clip_active(sel), vc["camera_pos"],
                      ts.lod_ranges(), vc["world_to_clip"], cfg.width,
                      cfg.height, cfg.raster.subtile_h)
        if cfg.shadow_mode != "map":
            return sel.count, jnp.int32(-1), n_work, jnp.int32(-1)
        res = cfg.shadow_resolution
        wtc = shadow.sun_shear_matrices(
            params.light_direction, float(ts.world_size), params.max_height,
            res)[0]
        light, l_eye, l_ranges = jr._light_select(params, wtc,
                                                  vc["camera_pos"])
        l_work = work(light, l_eye, l_ranges, wtc, res, res,
                      cfg.raster.light_subtile_h)
        return sel.count, light.count, n_work, l_work

    return jax.jit(terms) if jit else terms


def variant_counts(bench, name, mode, quant, res):
    """The stored arrays of one variant: the JAX bench's cameras and, at
    each, the terms of ``_jax_terms`` op by op, and jitted (``*_jit``)."""
    import jax

    jr, params, jcams = bench_build(bench, mode, quant, res)
    eye, target, up = _cams_np(jcams)
    out = {f"{name}:eye": eye, f"{name}:target": target, f"{name}:up": up}
    for suffix, terms in (("", _jax_terms(jr, params, jit=False)),
                          ("_jit", _jax_terms(jr, params))):
        with jax.disable_jit(not suffix):
            rows = np.asarray([[int(v) for v in terms(eye[i], target[i],
                                                      up[i])]
                               for i in range(workloads.N_CAMERAS)], np.int64)
        for j, key in enumerate(("selected", "light_selected", "work",
                                 "light_work")):
            out[f"{name}:{key}{suffix}"] = rows[:, j]
    return out


def write_counts(path=COUNTS):
    bench = load_bench()
    out = {}
    for variant in VARIANTS:
        out.update(variant_counts(bench, *variant))
        name = variant[0]
        print(name + ": " + ", ".join(
            f"{k} {out[f'{name}:{k}'].min()}-{out[f'{name}:{k}'].max()}"
            for k in ("selected", "light_selected", "work", "light_work")),
            flush=True)
    np.savez_compressed(path, **out)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        raise SystemExit("usage: python tests/test_torch_workloads.py --write")
    sys.path.insert(0, HERE)
    import conftest  # noqa: F401  (JAX on the CPU, as the tests run it)

    write_counts()
