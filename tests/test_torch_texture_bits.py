"""The vertex stage's texture products give the CPU's bits on every device
(ROADMAP C: the card's vertex stage once binned other work items than the
CPU at the envelope's camera 40, and a matrix product on the card sums the
taps in an order nothing pins).

``sample_separable`` and ``sample_points_matmul`` gather each sample's two
taps an axis and form fl(w1 a1 + fl(w0 a0)) with ``math3d.fma32``. Held
here, bit for bit, at the vertex stage's shapes (the selections of bench.py's
envelope, 1024 slots, and of the 1080p flythrough, 512 slots; 33 vertices a
side; the 256^2 heightmap and the 7-channel attribute texture; lattice and
d3d addressing; one PyTorch thread) against the einsum form the port used
before, and against the JAX package's functions. JAX's row products and
``sample_points_matmul`` equal the port's bit for bit. Its column product
of ``sample_separable`` does not everywhere, on the reference's side: XLA's
CPU contraction rounds the two products separately, fl(fl(w0 r0) +
fl(w1 r1)), for every sample of a 2-D texture and, for the 3-D one, where
the taps straddle a block of its contraction (texels 140 and 141 at these
shapes); the test pins that each of JAX's samples is one of the two forms
(the counts that follow from the heights are held to JAX's in
tests/test_torch_workloads.py). ``fma32`` itself is held to the
exactly rounded w1 a1 + p0, including a case where rounding the float64 sum
twice would be wrong.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import torch_parity  # noqa: F401  (one PyTorch thread a test process)
from vrenderer_tpu.ops import texture as jtexture
from vrenderer_tpu_torch import workloads
from vrenderer_tpu_torch.ops import shadow, texture
from vrenderer_tpu_torch.terrain import quadtree
from vrenderer_tpu_torch.utils import math3d

# (workload mode, camera): bench.py's envelope (max_active 1024) at the
# camera the card once binned otherwise, the 1080p flythrough (512) at its
# grazing view
VIEWS = {"envelope": ("envelope", 40), "1080p": ("1080p", 13)}
CASES = [("envelope", "lattice"), ("1080p", "lattice"), ("1080p", "d3d")]


def einsum_separable(tex, u, v, mode):
    """The port's earlier form, the JAX package's: (rows, samples)."""
    H, W = tex.shape[0], tex.shape[1]
    au = texture.interp_matrix(u, W, mode)
    av = texture.interp_matrix(v, H, mode)
    if tex.ndim == 2:
        rows = torch.einsum("...vh,hw->...vw", av, tex)
        return rows, torch.einsum("...vw,...uw->...vu", rows, au)
    rows = torch.einsum("...vh,hwc->...vwc", av, tex)
    return rows, torch.einsum("...vwc,...uw->...vuc", rows, au)


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def views():
    """Per view: the lattice's (u, v) as the vertex stage forms them, the
    heightmap and the attribute texture (albedo, normal field, horizon
    shadow field)."""
    out = {}
    for name, (mode, cam_i) in VIEWS.items():
        r, params, cams = workloads.build(mode, "cpu")
        ts = r.config.terrain
        vc = r._view(cams.frame(cam_i))
        inst = r._clip_active(quadtree.select_all_surfaces(
            ts, vc["camera_pos"], math3d.frustum_planes(vc["world_to_clip"]),
            ts.lod_ranges()))
        g = math3d.linspace(-1.0, 1.0, ts.verts_per_side)
        world = float(ts.world_size)
        u = texture.world_to_uv(inst.position[:, 0:1]
                                + inst.extents[:, 0:1] * g[None, :], world)
        v = texture.world_to_uv(inst.position[:, 2:3]
                                + inst.extents[:, 2:3] * g[None, :], world)
        field = shadow.horizon_shadow_field(r.heightmap, params.max_height,
                                            world, params.light_direction)
        vis = torch.cat([r.albedo, r._nrm_field, field[..., None]], dim=-1)
        out[name] = {"u": u, "v": v, "hm": r.heightmap, "vis": vis,
                     "slots": inst.position.shape[0]}
    return out


def test_views_have_the_workloads_slots(views):
    assert views["envelope"]["slots"] == 1024
    assert views["1080p"]["slots"] == 512
    assert views["envelope"]["u"].shape == (1024, 33)


@pytest.mark.parametrize("tex", ["hm", "vis"])
@pytest.mark.parametrize("view,mode", CASES)
def test_separable_matches_einsum_and_jax(views, view, mode, tex):
    x = views[view]
    t, u, v = x[tex], x["u"], x["v"]
    got = texture.sample_separable(t, u, v, mode=mode)
    rows, old = einsum_separable(t, u, v, mode)
    np.testing.assert_array_equal(bits(got), bits(old))
    # JAX's row product is the port's bit for bit
    sub = "...vh,hw->...vw" if t.ndim == 2 else "...vh,hwc->...vwc"
    j_rows = jnp.einsum(sub, jnp.asarray(texture.interp_matrix(
        v, t.shape[0], mode).numpy()), jnp.asarray(t.numpy()),
        precision=lax.Precision.HIGHEST)
    np.testing.assert_array_equal(bits(j_rows), bits(rows))
    # each output of its column product is the port's fused form or the
    # two products rounded and added
    want = bits(jtexture.sample_separable(
        jnp.asarray(t.numpy()), jnp.asarray(u.numpy()),
        jnp.asarray(v.numpy()), mode=mode))
    x0, x1, w0, w1 = texture.bilinear_taps(u, t.shape[1], mode)
    ch = (None,) * (t.ndim - 2)
    w0, w1 = (w[(slice(None), None, slice(None)) + ch] for w in (w0, w1))

    def tap(i):
        idx = i[(slice(None), None, slice(None)) + ch].expand(
            got.shape).contiguous()
        return torch.gather(rows, 2, idx)

    p0, p1 = w0 * tap(x0), w1 * tap(x1)
    split = bits(p0 + p1)
    assert ((want == bits(got)) | (want == split)).all()
    if t.ndim == 2:       # the batched product of a 2-D texture: always
        np.testing.assert_array_equal(want, split)
    diff = np.abs(np.asarray(got, np.float64) - want.view(np.float32))
    assert (diff <= 2 * 2.0 ** -24 * (p0.abs() + p1.abs()).numpy()).all()


def test_points_match_matmul_form_and_jax(views):
    """``sample_points_matmul`` at the boot cube's receiver points (and
    spread points) of a 2-D and the 3-D texture."""
    x = views["envelope"]
    rng = np.random.default_rng(3)
    pu = torch.as_tensor(rng.random(4096, dtype=np.float32))
    pv = torch.as_tensor(rng.random(4096, dtype=np.float32))
    pu[:3] = torch.tensor([0.0, 1.0, 0.5])      # both edges, a texel centre
    pv[:3] = torch.tensor([1.0, 0.0, 0.25])
    for tex in (x["hm"], x["vis"]):
        H, W = tex.shape[0], tex.shape[1]
        av, au = texture.interp_matrix(pv, H), texture.interp_matrix(pu, W)
        if tex.ndim == 2:
            old = torch.sum((av @ tex) * au, dim=-1)
        else:
            old = torch.sum(torch.einsum("nh,hwc->nwc", av, tex)
                            * au[..., None], dim=1)
        got = texture.sample_points_matmul(tex, pu, pv)
        want = jtexture.sample_points_matmul(
            jnp.asarray(tex.numpy()), jnp.asarray(pu.numpy()),
            jnp.asarray(pv.numpy()))
        np.testing.assert_array_equal(bits(got), bits(old))
        np.testing.assert_array_equal(bits(got), bits(want))


def _round_f32(x: Fraction) -> float:
    """x rounded to the nearest float32, ties to even (normal range)."""
    if x == 0:
        return 0.0
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    scaled = x / Fraction(2) ** (e - 23)        # in [2^23, 2^24)
    m, rem = divmod(scaled.numerator, scaled.denominator)
    half = Fraction(rem, scaled.denominator)
    if half > Fraction(1, 2) or (half == Fraction(1, 2) and m % 2):
        m += 1
    return sign * float(Fraction(m) * Fraction(2) ** (e - 23))


def test_fma32_rounds_once():
    rng = np.random.default_rng(7)
    n = 3000
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)
         ).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)
         ).astype(np.float32)
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-40, 40, n)
         ).astype(np.float32)
    # a double-rounding case: a*b = 2^-24 - 2^-54 below a half-ulp of c, an
    # odd float32: the exact sum rounds down, the float64 sum to the tie
    a[0], b[0] = 1 + 2.0 ** -15, (1 - 2.0 ** -15) * 2.0 ** -24
    c[0] = 1 + 2.0 ** -23
    got = math3d.fma32(torch.as_tensor(a), torch.as_tensor(b),
                       torch.as_tensor(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert got[0] == np.float32(1 + 2.0 ** -23)
    naive = (a[:1].astype(np.float64) * b[:1] + c[:1]).astype(np.float32)
    assert naive[0] != got[0]
