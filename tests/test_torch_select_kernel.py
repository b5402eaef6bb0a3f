"""The selection kernel ``vrt_select`` (``quadtree.select_cuda``,
csrc/select.cu) against the plain sweep it replaces on the card
(``select_nodes_plain``, ``select_all_surfaces_plain``), bit for bit:
positions, extents, lod, valid, count and the debug masks, on the card's
plain sweep and on the host's.

Inputs: tests/test_torch_quadtree.py's cameras over its 64 m and 256 m
surfaces; the 64 flythrough cameras with their main frustums and with the
light frustums of ``shadow.sun_shear_matrices`` at 2048^2 and 1024^2, the
ranges scaled by ``shadow_lod_bias`` 1 and 2, the quantized light eye and
the light-view proxy eye; mapwalk's ground-height cameras 8, 20, 24 and 28;
a budget small enough that ``count`` passes it; the envelope's 2x2
surfaces. The matrices are made on the host and
moved to the card, as the renderer makes them.

CPU cases check the dispatch (CPU tensors never reach the kernel) and the
wrapper's checks; CUDA cases (marker ``cuda``) skip where there is no card.
The file imports no JAX, so on the machine with the card it runs without
the repository's conftest:

    python -m pytest tests/test_torch_select_kernel.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from vrenderer_tpu_torch import workloads
from vrenderer_tpu_torch.camera import Camera, make_view_constants
from vrenderer_tpu_torch.config import LightParams, TerrainSettings
from vrenderer_tpu_torch.ops import shadow
from vrenderer_tpu_torch.terrain import heightmap as hmod
from vrenderer_tpu_torch.terrain import quadtree
from vrenderer_tpu_torch.utils import math3d

SMALL = TerrainSettings(surface_size=64, world_size=64, max_instances=512)
MAPWALK_GROUND = (8, 20, 24, 28)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _planes(eye, target, aspect=1.0, far=1000.0):
    """The frustum of tests/test_quadtree.py's ``_make_frustum``, made on
    the host."""
    cam = Camera(eye=torch.tensor(eye, dtype=torch.float32),
                 target=torch.tensor(target, dtype=torch.float32),
                 up=torch.tensor([0.0, 1.0, 0.0]))
    vc = make_view_constants(cam, 1, 1, 60.0, 0.1, far)
    return cam.eye, math3d.frustum_planes(vc["world_to_clip"])


def _quadtree_cameras():
    """tests/test_torch_quadtree.py's cameras: 4 random ones, overhead,
    far away."""
    out = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        eye = np.array([rng.uniform(-40, 40), rng.uniform(2, 60),
                        rng.uniform(-40, 40)])
        target = eye + np.array([rng.uniform(-1, 1), rng.uniform(-0.9, -0.1),
                                 rng.uniform(-1, 1)]) * 10.0
        out.append((eye, target))
    out.append((np.array([0.5, 30.0, 0.5]), np.zeros(3)))
    far = np.array([10000.0, 100.0, 10000.0])
    out.append((far, far + np.array([0.0, -1.0, -1.0])))
    return out


def _main_views(mode, cams, idx):
    """(eye, main frustum planes) of cameras ``idx`` of ``mode``."""
    cfg = workloads.config(mode)
    out = []
    for i in idx:
        vc = make_view_constants(cams.frame(i), cfg.width, cfg.height,
                                 cfg.vfov_degrees, cfg.z_near, cfg.z_far)
        out.append((vc["camera_pos"],
                    math3d.frustum_planes(vc["world_to_clip"])))
    return out


def _light_planes(ts, res):
    light = torch.tensor(LightParams().direction, dtype=torch.float32)
    wtc = shadow.sun_shear_matrices(light, float(ts.world_size),
                                    torch.tensor(workloads.MAX_HEIGHT), res)[0]
    return light, math3d.frustum_planes(wtc)


def _cases():
    """(name, settings, eye, planes, ranges, per_side), all on the
    host."""
    out = []
    big = dataclasses.replace(SMALL, surface_size=256, world_size=256,
                              max_instances=1024)
    for ts in (SMALL, big):
        for k, (eye, target) in enumerate(_quadtree_cameras()):
            e, p = _planes(eye * ts.surface_size / 64,
                           target * ts.surface_size / 64)
            out.append((f"quadtree{ts.surface_size}-{k}", ts, e, p,
                        ts.lod_ranges(), 1))
    hm = hmod.procedural_heightmap(256)
    ts = workloads.config("1080p").terrain
    ranges = ts.lod_ranges()
    fly = workloads.cameras("1080p", hm, float(ts.world_size))
    light_dir, light = {}, {}
    for res in (2048, 1024):
        light_dir[res], light[res] = _light_planes(ts, res)
    proxy = -math3d.normalize_rn(light_dir[2048]) * float(ts.world_size)
    out.append(("light-proxy-eye", ts, proxy, light[2048], ranges, 1))
    tight = dataclasses.replace(ts, max_instances=16)
    for i, (eye, planes) in enumerate(_main_views("1080p", fly, range(64))):
        out.append((f"fly{i}", ts, eye, planes, ranges, 1))
        out.append((f"fly{i}-cap16", tight, eye, planes, ranges, 1))
        for res in (2048, 1024):
            out.append((f"fly{i}-light{res}", ts, eye, light[res], ranges,
                        1))
        for bias in (1, 2):
            out.append((f"fly{i}-light-bias{bias}", ts, eye, light[2048],
                        ranges * (0.5 ** bias), 1))
        for q in (64.0, 256.0):
            qt = torch.tensor(q, dtype=torch.float32)
            out.append((f"fly{i}-light-quant{q:g}", ts,
                        (torch.floor(eye / qt) + 0.5) * qt, light[2048],
                        ranges, 1))
    walk = workloads.cameras("mapwalk", hm, float(ts.world_size))
    for i, (eye, planes) in zip(MAPWALK_GROUND, _main_views(
            "mapwalk", walk, MAPWALK_GROUND)):
        out.append((f"mapwalk{i}", ts, eye, planes, ranges, 1))
        out.append((f"mapwalk{i}-light", ts, eye, light[2048], ranges, 1))
    env = workloads.config("envelope").terrain
    env_small = dataclasses.replace(env, max_instances=64)
    orbit = workloads.cameras("envelope", hm, float(env.world_size))
    for i, (eye, planes) in zip(range(0, 64, 8), _main_views(
            "envelope", orbit, range(0, 64, 8))):
        for t in (env, env_small):
            out.append((f"envelope{i}-cap{t.max_instances}", t, eye, planes,
                        ranges, 2))
    return out


def _plain(ts, eye, planes, ranges, per_side):
    if per_side == 1:
        return quadtree.select_nodes_plain(ts, eye, planes, ranges)
    return quadtree.select_all_surfaces_plain(ts, eye, planes, ranges), None


def _bits(x):
    x = x.cpu()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(name, got, want):
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (name, f)
        assert torch.equal(_bits(a), _bits(b)), (name, f)


def test_the_cpu_takes_the_plain_sweep(monkeypatch):
    """On CPU tensors both entry points return the plain versions' results
    and never reach the kernel's wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached select_cuda")

    monkeypatch.setattr(quadtree, "select_cuda", refuse)
    eye, planes = _planes([10.0, 20.0, 5.0], [0.0, 0.0, 0.0])
    for ts in (SMALL, dataclasses.replace(SMALL, world_size=128,
                                          max_instances=40)):
        inst, dbg = quadtree.select_nodes(ts, eye, planes, ts.lod_ranges())
        want, want_dbg = quadtree.select_nodes_plain(ts, eye, planes,
                                                     ts.lod_ranges())
        _assert_same("nodes", inst, want)
        _assert_same("debug", dbg, want_dbg)
        _assert_same("all", quadtree.select_all_surfaces(
            ts, eye, planes, ts.lod_ranges()),
            quadtree.select_all_surfaces_plain(ts, eye, planes,
                                               ts.lod_ranges()))
        assert int(inst.count) > 0


def _inputs():
    eye, planes = _planes([10.0, 20.0, 5.0], [0.0, 0.0, 0.0])
    return eye, planes, SMALL.lod_ranges()


@pytest.mark.parametrize("change,words", [
    ("window", ("select_window 33", "1089 threads", "1024")),
    ("camera_shape", ("camera_pos", "(4,)", "(3,)")),
    ("planes_shape", ("frustum_planes", "(4, 6)", "(6, 4)")),
    ("ranges_shape", ("lod_ranges", "(6,)", "(12,)")),
    ("camera_dtype", ("camera_pos", "torch.float64", "torch.float32")),
    ("planes_dtype", ("frustum_planes", "torch.float16")),
    ("ranges_dtype", ("lod_ranges", "torch.int32")),
    ("planes_device", ("frustum_planes", "meta", "cpu")),
    ("ranges_device", ("lod_ranges", "meta", "cpu")),
    ("camera_device", ("frustum_planes", "cpu", "the camera on meta")),
    ("cpu", ("CUDA device", "cpu")),
])
def test_select_cuda_names_what_it_rejects(change, words):
    """The wrapper's checks run before any launch, so they hold on the
    CPU: each raises a ValueError naming the input and what it needs."""
    eye, planes, ranges = _inputs()
    ts = SMALL
    if change == "window":
        ts = dataclasses.replace(SMALL, select_window=33)
    elif change == "camera_shape":
        eye = torch.zeros(4)
    elif change == "planes_shape":
        planes = planes.T
    elif change == "ranges_shape":
        ranges = ranges[:6]
    elif change == "camera_dtype":
        eye = eye.double()
    elif change == "planes_dtype":
        planes = planes.half()
    elif change == "ranges_dtype":
        ranges = ranges.int()
    elif change == "planes_device":
        planes = planes.to("meta")
    elif change == "ranges_device":
        ranges = ranges.to("meta")
    elif change == "camera_device":
        eye = eye.to("meta")
    with pytest.raises(ValueError) as err:
        quadtree.select_cuda(ts, eye, planes, ranges)
    for w in words:
        assert w in str(err.value), (w, str(err.value))


@pytest.mark.cuda
def test_kernel_equals_the_plain_sweep(card):
    """Every case's instances (and, for one surface, its debug masks) bit
    for bit equal to the plain sweep on the card and on the host; one
    launch a call."""
    cases = _cases()
    overflow = 0
    for name, ts, eye, planes, ranges, per_side in cases:
        host = _plain(ts, eye, planes, ranges, per_side)
        args = [x.to(card) for x in (eye, planes, ranges)]
        on_card = _plain(ts, *args, per_side)
        before = quadtree.select_cuda.launches
        got = quadtree.select_cuda(ts, *args, per_side)
        assert quadtree.select_cuda.launches == before + 1
        for want in (on_card, host):
            _assert_same(name, got[0], want[0])
            if per_side == 1:
                _assert_same(name, got[1], want[1])
        if per_side == 1:
            _assert_same(name, quadtree.select_nodes(ts, *args)[0], host[0])
        _assert_same(name, quadtree.select_all_surfaces(ts, *args), host[0])
        overflow += int(got[0].count) > ts.max_instances
    assert len(cases) == 12 + 1 + 64 * 8 + 4 * 2 + 8 * 2
    assert overflow > 64      # the budgets of 16 and 64 slots overflow


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["1080p", "map"])
def test_a_frames_selection_syncs_nothing(card, mode):
    """One horizon frame's selection and one map frame's (the light view's
    and the main view's that the shared geometry is masked to) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing raises."""
    r, params, cams = workloads.build(mode, device=card)
    cam = cams.frame(13)
    vc = r._view(cam)
    wtc_l = shadow.sun_shear_matrices(params.light_direction,
                                      float(r.config.terrain.world_size),
                                      params.max_height,
                                      r.config.shadow_resolution)[0]
    mode_before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        main = r._clip_active(quadtree.select_all_surfaces(
            r.config.terrain, vc["camera_pos"],
            math3d.frustum_planes(vc["world_to_clip"]), r.lod_ranges))
        if mode == "map":
            light = r._light_select(params, wtc_l, vc["camera_pos"])[0]
            members = r._main_members(light, vc)
    finally:
        torch.cuda.set_sync_debug_mode(mode_before)
    assert int(main.count) > 0
    if mode == "map":
        assert int(light.count) >= int(members.valid.sum()) > 0
