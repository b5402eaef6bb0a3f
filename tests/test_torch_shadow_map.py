"""Map-mode shadow math of the port against ``vrenderer_tpu.ops.shadow``:
the sheared light view, occluder heights, the terrain factors and the mesh
receivers' factors, on the same numpy inputs.

Tolerances: matrices and spans to 1e-6 relative (the same float32 ops,
the final product summed in another order); occluder heights exactly.
The samplers gather where the JAX package multiplies by bilinear weight
matrices, with the same weights in the same rows-then-columns order, so a
sample may differ only where a matrix product fuses its two terms into
one rounding; a comparison against it can then flip only at an exact tie.
So factors are equal on at least 99.9% of receivers, and any other
receiver differs by at most one tap's weight (0.25).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close
from vrenderer_tpu.ops import shadow as jshadow
from vrenderer_tpu_torch.ops import shadow as tshadow

WORLD, MAX_H, RES = 64.0, 12.0, 128

_SUNS = {
    "default": (-0.9, -0.25, 0.35),
    "random": tuple(np.random.default_rng(11).uniform(-1.0, 1.0, 3)
                    * np.array([1.0, 0.0, 1.0]) + np.array([0.0, -0.6, 0.0])),
    # 6 degrees above the horizon: the shear vector is clamped to k_max
    "low": (-0.95, -0.1, 0.3),
    "high": (0.2, -0.95, -0.1),
}


def _sun(name):
    d = np.asarray(_SUNS[name], np.float32)
    return jnp.asarray(d), torch.as_tensor(d)


def _shear(name):
    jd, td = _sun(name)
    j = jshadow.sun_shear_matrices(jd, WORLD, jnp.float32(MAX_H), RES)
    t = tshadow.sun_shear_matrices(td, WORLD, torch.tensor(MAX_H), RES)
    return j, t


@pytest.mark.parametrize("sun", sorted(_SUNS))
def test_sun_shear_matrices_match(sun):
    j, t = _shear(sun)
    scale = float(np.abs(np.asarray(j[0])).max())
    assert_close(t[0], j[0], rtol=1e-6, atol=1e-6 * scale)
    for a, b in zip(t[1:], j[1:]):
        assert_close(a, b, rtol=1e-6)
    k = np.hypot(float(t[1]), float(t[2]))
    if sun == "low":
        assert abs(k - 4.0) < 1e-5          # clamped, direction kept
        assert_close(t[2] / t[1], j[2] / j[1], rtol=1e-6)
    else:
        assert k < 4.0


def _depth_map(seed=0):
    """Light-view z around the map's ground level, a quarter background."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.4994, 0.5001, (RES, RES)).astype(np.float32)
    z[rng.random((RES, RES)) < 0.25] = np.float32(3.0e38)
    return z


def test_shear_map_heights_exact():
    z = _depth_map()
    j = jshadow.shear_map_heights(jnp.asarray(z), jnp.asarray(z < 2.0))
    t = tshadow.shear_map_heights(torch.as_tensor(z), torch.as_tensor(z < 2.0))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _assert_factors_match(t, j):
    t, j = t.numpy(), np.asarray(j)
    assert (t == 1.0).any() and (t < 1.0).any()     # lit and shadowed
    same = t == j
    assert same.mean() >= 0.999
    assert np.abs(t - j).max() <= 0.25


@pytest.mark.parametrize("sun", sorted(_SUNS))
def test_factors_from_sun_shear_map_match(sun):
    z = _depth_map(1)
    hm = np.random.default_rng(2).random((64, 64)).astype(np.float32)
    (_, *jsh), (_, *tsh) = _shear(sun)
    jd, td = _sun(sun)
    j = jshadow.factors_from_sun_shear_map(
        jshadow.shear_map_heights(jnp.asarray(z), jnp.asarray(z < 2.0)),
        jnp.asarray(hm), jnp.float32(MAX_H), WORLD, *jsh, -jd[1])
    t = tshadow.factors_from_sun_shear_map(
        tshadow.shear_map_heights(torch.as_tensor(z), torch.as_tensor(z < 2)),
        torch.as_tensor(hm), torch.tensor(MAX_H), WORLD, *tsh, -td[1])
    assert t.shape == (64, 64)
    _assert_factors_match(t, j)


@pytest.mark.parametrize("sun", sorted(_SUNS))
def test_shadow_factors_from_map_match(sun):
    z = _depth_map(3)
    rng = np.random.default_rng(4)
    pts = np.stack([rng.uniform(-WORLD / 2, WORLD / 2, 3000),
                    rng.uniform(0.0, MAX_H, 3000),
                    rng.uniform(-WORLD / 2, WORLD / 2, 3000)],
                   -1).astype(np.float32)
    (jw, *_), (tw, *_) = _shear(sun)
    z_range = jshadow._SHEAR_FAR - 1.0
    j = jshadow.shadow_factors_from_map(jnp.asarray(z), jw, z_range,
                                        jnp.asarray(pts))
    t = tshadow.shadow_factors_from_map(torch.as_tensor(z),
                                        torch.tensor(np.asarray(jw)),
                                        z_range, torch.as_tensor(pts))
    assert t.shape == (3000,)
    _assert_factors_match(t, j)


@pytest.mark.parametrize("light", [(-0.9, -0.25, 0.35), (0.05, -1.0, 0.02)])
def test_light_view_matrices_match(light):
    d = np.asarray(light, np.float32)
    j = jshadow.light_view_matrices(jnp.asarray(d), 2048.0, jnp.float32(400.0),
                                    2048)
    t = tshadow.light_view_matrices(torch.as_tensor(d), 2048.0,
                                    torch.tensor(400.0), 2048)
    scale = float(np.abs(np.asarray(j)).max())
    assert_close(t, j, rtol=1e-6, atol=1e-6 * scale)
