"""The port's CDLOD selection against the reference recursion of
tests/test_quadtree.py (``oracle_select``, a straight port of
QuadTree::NodeSelect), and its debug view (``SelectionDebug``,
``Renderer.debug_selection``) and single-tile selection against
vrenderer_tpu's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_quadtree import _make_frustum, oracle_select
from torch_parity import JCFG, CFG, cameras, frame_params_pair
from vrenderer_tpu.config import TerrainSettings as JTerrainSettings
from vrenderer_tpu.renderer import Renderer as JRenderer
from vrenderer_tpu.terrain import heightmap as jhmod
from vrenderer_tpu.terrain import quadtree as jquadtree
from vrenderer_tpu_torch import convert
from vrenderer_tpu_torch.renderer import Renderer
from vrenderer_tpu_torch.terrain import quadtree

JSET = JTerrainSettings(surface_size=64, world_size=64, max_instances=512)
SET = convert.frame_config(dataclasses.asdict(
    dataclasses.replace(JCFG, terrain=JSET))).terrain


def _selected_set(inst):
    pos, ext = inst.position.numpy(), inst.extents.numpy()
    return {(round(float(pos[i, 0]), 3), round(float(pos[i, 2]), 3),
             round(float(ext[i, 0]), 3))
            for i in np.flatnonzero(inst.valid.numpy())}


def _cameras():
    """tests/test_quadtree.py's cameras: 4 of its random ones, overhead,
    far away."""
    out = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        eye = np.array([rng.uniform(-40, 40), rng.uniform(2, 60),
                        rng.uniform(-40, 40)])
        target = eye + np.array([rng.uniform(-1, 1), rng.uniform(-0.9, -0.1),
                                 rng.uniform(-1, 1)]) * 10.0
        out.append((f"random{seed}", eye, target))
    out.append(("overhead", np.array([0.5, 30.0, 0.5]), np.zeros(3)))
    far = np.array([10000.0, 100.0, 10000.0])
    out.append(("far", far, far + np.array([0.0, -1.0, -1.0])))
    return out


@pytest.mark.parametrize("name,eye,target", _cameras(),
                         ids=[c[0] for c in _cameras()])
def test_select_nodes_matches_reference_recursion(name, eye, target):
    planes = _make_frustum(eye, target)
    expect = oracle_select(JSET, eye, planes)
    inst, dbg = quadtree.select_nodes(
        SET, torch.tensor(eye, dtype=torch.float32),
        torch.tensor(planes, dtype=torch.float32), SET.lod_ranges())
    assert _selected_set(inst) == expect
    assert int(inst.count) == len(expect) == int(dbg.selected.sum())
    jinst, jdbg = jquadtree.select_nodes(
        JSET, jnp.asarray(eye, jnp.float32), jnp.asarray(planes, jnp.float32),
        JSET.lod_ranges())
    for f in ("selected", "culled", "origin"):
        np.testing.assert_array_equal(getattr(dbg, f).numpy(),
                                      np.asarray(getattr(jdbg, f)), f)
    assert not bool((dbg.selected & dbg.culled).any())


def test_larger_surface_matches_reference_recursion():
    jset = JTerrainSettings(surface_size=256, world_size=256,
                            max_instances=1024)
    tset = dataclasses.replace(SET, surface_size=256, world_size=256,
                               max_instances=1024)
    rng = np.random.default_rng(42)
    for _ in range(3):
        eye = np.array([rng.uniform(-120, 120), rng.uniform(5, 80),
                        rng.uniform(-120, 120)])
        target = eye + np.array([rng.uniform(-1, 1), -0.5,
                                 rng.uniform(-1, 1)]) * 20.0
        planes = _make_frustum(eye, target)
        inst, _ = quadtree.select_nodes(
            tset, torch.tensor(eye, dtype=torch.float32),
            torch.tensor(planes, dtype=torch.float32), tset.lod_ranges())
        assert _selected_set(inst) == oracle_select(jset, eye, planes)


@pytest.fixture(scope="module")
def renderers():
    hm = jhmod.procedural_heightmap(64, seed=7)
    alb = jhmod.procedural_albedo(hm)
    jr = JRenderer(JCFG, hm, alb, raster_backend="xla")
    r = Renderer(CFG, convert.tensor(np.asarray(hm)),
                 convert.tensor(np.asarray(alb)), raster_backend="xla",
                 device="cpu")
    return jr, r


@pytest.mark.parametrize("view,culls", [
    (([0.0, 25.0, 45.0], [0.0, 0.0, 0.0]), False),
    (([20.0, 6.0, -5.0], [-10.0, 2.0, 10.0]), True)], ids=["golden", "low"])
def test_debug_selection_matches_jax(renderers, view, culls):
    """Renderer.debug_selection: per-level selected and culled masks and
    window origins equal to JAX's; the selected nodes are the render's
    selection; the low view culls nodes in range, the golden one none."""
    jr, r = renderers
    jcam, cam = cameras(*view)
    jd, d = jr.debug_selection(jcam), r.debug_selection(cam)
    ts = CFG.terrain
    assert d.selected.shape == (ts.num_lods + 1, ts.select_window,
                                ts.select_window)
    for f in ("selected", "culled", "origin"):
        np.testing.assert_array_equal(getattr(d, f).numpy(),
                                      np.asarray(getattr(jd, f)), f)
    assert int(d.selected.sum()) == int(r.select(cam).count) > 0
    assert bool(d.culled.any()) == culls


def test_single_tile_instances_match_jax(renderers):
    """One root node over the whole surface, equal to JAX's array for
    array; the locked frame through it draws that one instance over the
    view."""
    _, r = renderers
    jinst = jquadtree.single_tile_instances(JCFG.terrain)
    inst = quadtree.single_tile_instances(CFG.terrain, device="cpu")
    for a, b in zip(inst, jinst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == convert.tensor(np.asarray(b)).dtype
    _, cam = cameras([0.0, 25.0, 45.0], [0.0, 0.0, 0.0])
    _, p = frame_params_pair()
    out = r.render_locked(cam, p, inst)
    assert int(out.prim_id.max()) < CFG.terrain.tris_per_instance
    assert (out.prim_id.numpy() >= 0).mean() > 0.3
    assert int(out.num_instances) == 1
