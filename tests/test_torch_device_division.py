"""The shadow phase and the view rays give the same bits whether a division
by a Python number divides or multiplies by the number's reciprocal.

PyTorch's true division on a CUDA tensor by a host scalar (a Python number
or a CPU 0-dim tensor) multiplies by the scalar's reciprocal rounded to
float32, which may be off by an ulp; the CPU divides. The horizon prepass
once divided its march by such numbers, and the card's shadow field
differed from the CPU's at 1755 of 65536 texels (ROADMAP C1). The port now
divides by numbers through ``math3d.div_rn`` (a divisor tensor on the
dividend's device). Here ``card_division`` makes the CPU divide as the card
does, so these tests need no card and fail where a division by a host
scalar is left on the shadow phase or the view rays.

    python -m pytest tests/test_torch_device_division.py -q
"""

import contextlib
import numbers

import numpy as np
import pytest
import torch

from vrenderer_tpu_torch import workloads
from vrenderer_tpu_torch.ops import shadow, texture
from vrenderer_tpu_torch.utils import math3d


@contextlib.contextmanager
def card_division():
    """``tensor / number`` as the card computes it, tensor * fl(1/number)
    (the reciprocal taken in float64 and rounded to float32); restores
    ``torch.Tensor.__truediv__`` on exit."""
    true_div = torch.Tensor.__truediv__

    def div(self, other):
        if (isinstance(other, numbers.Real) and not isinstance(other, bool)
                and self.is_floating_point()):
            return self * float(np.float32(1.0 / other))
        return true_div(self, other)

    torch.Tensor.__truediv__ = div
    try:
        yield
    finally:
        torch.Tensor.__truediv__ = true_div


def _bits(a, b):
    """Elements whose bits differ (floats compared as integers)."""
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def _both(fn):
    """``fn()`` as the CPU divides and as the card divides."""
    want = fn()
    with card_division():
        got = fn()
    return want, got


@pytest.fixture(scope="module")
def builds():
    """The CPU renderers, parameters and cameras of the modes used here,
    built once (no JAX)."""
    cache = {}

    def get(mode, **kw):
        key = (mode, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = workloads.build(mode, "cpu", **kw)
        return cache[key]

    return get


def test_card_division_multiplies_by_the_reciprocal_and_restores():
    gen = torch.Generator().manual_seed(0)
    x = (torch.rand(4096, generator=gen) - 0.5) * 10
    want, got = _both(lambda: x / 0.03)
    assert torch.equal(got, x * float(np.float32(1.0 / 0.03)))
    assert _bits(got, want) > 0
    # a tensor divisor divides, on every device
    want_t, got_t = _both(lambda: math3d.div_rn(x, 0.03))
    assert torch.equal(want_t, want) and torch.equal(got_t, want)
    assert torch.equal(x / 0.03, want)


def test_div_rn_raises_for_a_divisor_on_another_device():
    x = torch.ones(3)
    with pytest.raises(ValueError, match="divisor"):
        math3d.div_rn(x, torch.ones((), device="meta"))


@pytest.mark.parametrize("mode", ["envelope", "1080p"])
def test_horizon_prepass_bits_under_card_division(builds, mode):
    """Field and shadow line with the boot cube as occluder, at the
    envelope's 4096 m world and at the 1080p default sun (2048 m)."""
    r, params, _ = builds(mode)
    ws = float(r.config.terrain.world_size)
    occ = shadow.mesh_top_field(r._scene_top_world(r.scene_transforms),
                                torch.ones((1,), dtype=torch.bool), ws,
                                r.heightmap.shape[0])
    assert bool((occ > -1e9).any())
    (f, l), (f_c, l_c) = _both(lambda: shadow.horizon_shadow_field(
        r.heightmap, params.max_height, ws, params.light_direction,
        occluder_h=occ, with_shadow_line=True))
    assert _bits(f_c, f) == 0 and _bits(l_c, l) == 0
    pre = r.horizon_shadow_prepass(params)
    assert torch.equal(pre[0], f) and torch.equal(pre[1], l)


@pytest.mark.parametrize("mode,camera", [("map", 13), ("mapwalk", 62)])
def test_map_samplers_bits_under_card_division(builds, mode, camera):
    """``factors_from_sun_shear_map`` (the renderer's terrain field) and
    ``shadow_factors_from_map`` at the boot cube's vertices and at the
    terrain lattice, from one 256^2 light pass."""
    r, params, cams = builds(mode, shadow_res=256)
    depth, wtc, z_range, _, shear = r._light_depth_pass(
        params, cams.eye[camera], r._scene_wa(params))
    f, f_c = _both(lambda: r.shadow_field_from_map(depth, shear, params))
    assert _bits(f_c, f) == 0
    ws = float(r.config.terrain.world_size)
    sw = r._scene_wa(params)[0]
    mesh = torch.cat([sw[b, :3 * n]
                      for b, n in enumerate(r._scene_block_nreal)])
    g = math3d.linspace(-ws / 2, ws / 2, r.heightmap.shape[0])
    n = g.shape[0]
    lattice = torch.stack([g[None, :].expand(n, n),
                           r.heightmap * params.max_height,
                           g[:, None].expand(n, n)], -1).reshape(-1, 3)
    for pts in (mesh, lattice):
        for bias in (2.0, 0.0):
            s, s_c = _both(lambda: shadow.shadow_factors_from_map(
                depth, wtc, z_range, pts, bias_m=bias))
            assert _bits(s_c, s) == 0, bias


def test_view_rays_bits_under_card_division(builds):
    """The 1920x1152 frame's rays at flythrough camera 13, whole and as
    the middle of three bands."""
    r, _, cams = builds("1080p")
    vc = r._view(cams.frame(13))
    for band in (None, (384, 384)):
        rays, rays_c = _both(lambda: r._view_rays(vc, band))
        assert _bits(rays_c, rays) == 0, band


@pytest.mark.parametrize("world_size", [2048, 3000])
def test_world_to_uv_bits_under_card_division(world_size):
    gen = torch.Generator().manual_seed(1)
    x = (torch.rand(1 << 16, generator=gen) - 0.5) * world_size
    uv, uv_c = _both(lambda: texture.world_to_uv(x, world_size))
    assert _bits(uv_c, uv) == 0
