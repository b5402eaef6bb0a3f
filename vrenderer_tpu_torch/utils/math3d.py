"""3D math with the reference's conventions, on torch tensors.

The conventions are those of ``vrenderer_tpu.utils.math3d``:

* row vectors, ``v' = v @ M``;
* affines stored as (4, 3): a 3x3 linear part with a translation row;
* D3D-style projection: clip z in [0, 1], right-handed view space looking
  down -Z;
* y-down pixel coordinates with pixel centres at +0.5.

Every matrix product here is float32. On CUDA, torch runs float32 matmuls
without TF32 by default (``torch.backends.cuda.matmul.allow_tf32`` is
False); the JAX package pins the same products to ``Precision.HIGHEST``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """float32 ``linspace`` by JAX's formula, start*(1-s) + stop*s with
    s = i * float32(1/(num-1)) (as XLA compiles i/(num-1)) and an exact
    endpoint. It matches ``jnp.linspace`` bit for bit on [0, 1] and on the
    vertex grid's [-1, 1] with a power-of-two step count;
    ``torch.linspace`` rounds some interior points differently."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    div = num - 1
    inv = torch.tensor(1.0, dtype=torch.float32) / div
    step = torch.arange(div, dtype=torch.float32, device=device) * inv.item()
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


# ---------------------------------------------------------------------------
# Vectors
# ---------------------------------------------------------------------------

def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True) + eps)


def dot(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sum(a * b, dim=dim)


# ---------------------------------------------------------------------------
# Affine transforms (row-vector convention)
# ---------------------------------------------------------------------------

def affine_identity(device=None) -> torch.Tensor:
    return torch.cat([torch.eye(3, device=device),
                      torch.zeros((1, 3), device=device)], dim=0)


def affine_translation(t: torch.Tensor) -> torch.Tensor:
    """(..., 3) translation -> (..., 4, 3) affine."""
    batch = t.shape[:-1]
    lin = torch.eye(3, dtype=t.dtype, device=t.device).expand(batch + (3, 3))
    return torch.cat([lin, t[..., None, :]], dim=-2)


def affine_scaling(s: torch.Tensor) -> torch.Tensor:
    """(..., 3) scale -> (..., 4, 3) affine (TerrainPass.cpp:245)."""
    lin = torch.diag_embed(s)
    tr = torch.zeros(s.shape[:-1] + (1, 3), dtype=s.dtype, device=s.device)
    return torch.cat([lin, tr], dim=-2)


def affine_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-vector composition: v @ (a*b) == (v @ a) @ b."""
    lin = a[..., :3, :] @ b[..., :3, :]
    tr = a[..., 3:4, :] @ b[..., :3, :] + b[..., 3:4, :]
    return torch.cat([lin, tr], dim=-2)


def affine_apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply a (..., 4, 3) affine to (..., 3) points."""
    return torch.einsum("...i,...ij->...j", v, m[..., :3, :]) + m[..., 3, :]


def affine_to_homogeneous(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) affine -> (..., 4, 4) homogeneous (row-vector)."""
    col = torch.zeros(m.shape[:-2] + (4, 1), dtype=m.dtype, device=m.device)
    col[..., 3, 0] = 1.0
    return torch.cat([m, col], dim=-1)


# ---------------------------------------------------------------------------
# View / projection
# ---------------------------------------------------------------------------

def look_at(eye: torch.Tensor, target: torch.Tensor,
            up: torch.Tensor) -> torch.Tensor:
    """World -> view affine (4, 3), right-handed, camera looks down -Z
    (donut's FirstPersonCamera::LookAt, Renderer.cpp:97,317)."""
    fwd = normalize(target - eye)
    right = normalize(torch.linalg.cross(fwd, up))
    vup = torch.linalg.cross(right, fwd)
    lin = torch.stack([right, vup, -fwd], dim=-1)
    tr = -torch.stack([dot(eye, right), dot(eye, vup), dot(eye, -fwd)])
    return torch.cat([lin, tr[None, :]], dim=0)


def persp_proj_d3d_style(vfov_radians: float, aspect: float, z_near: float,
                         z_far: float, device=None) -> torch.Tensor:
    """math::perspProjD3DStyle (Renderer.cpp:315): clip.w = -view.z and
    ndc z = clip.z / clip.w in [0, 1]."""
    y_scale = 1.0 / math.tan(vfov_radians * 0.5)
    x_scale = y_scale / aspect
    a = z_far / (z_near - z_far)
    b = z_near * z_far / (z_near - z_far)
    return torch.tensor(
        [[x_scale, 0.0, 0.0, 0.0],
         [0.0, y_scale, 0.0, 0.0],
         [0.0, 0.0, a, -1.0],
         [0.0, 0.0, b, 0.0]],
        dtype=torch.float32, device=device,
    )


def ortho_proj_d3d_style(left, right, bottom, top, z_near: float,
                         z_far: float, device=None) -> torch.Tensor:
    """Row-vector right-handed ortho with D3D z in [0, 1]. The x/y bounds
    may be float32 scalar tensors (the sheared light view's spans); their
    entries are then computed in float32, as the JAX package traces them."""
    rl = right - left
    tb = top - bottom
    fn = z_far - z_near
    rows = [[2.0 / rl, 0.0, 0.0, 0.0],
            [0.0, 2.0 / tb, 0.0, 0.0],
            [0.0, 0.0, -1.0 / fn, 0.0],
            [-(right + left) / rl, -(top + bottom) / tb, -z_near / fn, 1.0]]
    if not isinstance(rl, torch.Tensor):
        return torch.tensor(rows, dtype=torch.float32, device=device)
    return torch.stack([torch.stack([
        torch.as_tensor(v, dtype=torch.float32, device=rl.device)
        for v in row]) for row in rows])


def view_proj(world_to_view: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Compose a (4, 3) world->view affine with a (4, 4) projection."""
    return affine_to_homogeneous(world_to_view) @ proj


def transform_points_h(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3) points through a (4, 4) row-vector matrix -> (..., 4),
    summed left to right."""
    return (v[..., 0:1] * m[0] + v[..., 1:2] * m[1] + v[..., 2:3] * m[2]
            + m[3])


def inverse_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert a (4, 3) row-vector affine (in float64, see inverse_4x4)."""
    lin_inv = torch.linalg.inv(m[:3, :].double())
    tr = -(m[3, :].double() @ lin_inv)
    return torch.cat([lin_inv, tr[None, :]], dim=0).to(m.dtype)


def inverse_4x4(m: torch.Tensor) -> torch.Tensor:
    """Inverse computed in float64 and rounded to m's dtype. A 1080p
    view-projection has a condition number near 1e6, so a float32 LU
    inverse (the JAX package's) is off by up to ~1e-2 relative and differs
    between LAPACK builds; in float64 the CPU and the card agree."""
    return torch.linalg.inv(m.double()).to(m.dtype)


# ---------------------------------------------------------------------------
# Frustum (dm::frustum semantics from the view-proj matrix)
# ---------------------------------------------------------------------------

def frustum_planes(vp: torch.Tensor) -> torch.Tensor:
    """Six planes (nx, ny, nz, d), inside where n.p + d >= 0: left w+x,
    right w-x, bottom w+y, top w-y, near z, far w-z. Returns (6, 4)."""
    x, y, z, w = vp.T
    return torch.stack([w + x, w - x, w + y, w - y, z, w - z], dim=0)


def frustum_intersects_box(planes: torch.Tensor, box_min: torch.Tensor,
                           box_max: torch.Tensor) -> torch.Tensor:
    """p-vertex AABB test (dm::frustum::intersectsWith, QuadTree.cpp:99):
    False only if the box lies fully outside some plane. The dot product
    is summed x, y, z in that order on every device (a reduction kernel
    on the card orders it otherwise, and boxes at the eye's height sit on
    planes through the eye)."""
    n = planes[:, :3]
    d = planes[:, 3]
    p_vert = torch.where(n >= 0.0, box_max[..., None, :], box_min[..., None, :])
    pn = p_vert * n
    dist = ((pn[..., 0] + pn[..., 1]) + pn[..., 2]) + d
    return torch.all(dist >= 0.0, dim=-1)


def aabb_dist2_xz(pos: torch.Tensor, box_min: torch.Tensor,
                  box_max: torch.Tensor) -> torch.Tensor:
    """Squared XZ distance from a point to an AABB; Y is ignored as in
    Node::Intersects (QuadTree.h:31-45)."""
    def axis(i):
        p = pos[..., i]
        lo, hi = box_min[..., i], box_max[..., i]
        return torch.where(p < lo, p - lo,
                           torch.where(p > hi, p - hi, torch.zeros_like(lo)))

    dx, dz = axis(0), axis(2)
    return dx * dx + dz * dz


# ---------------------------------------------------------------------------
# Viewport
# ---------------------------------------------------------------------------

def clip_to_screen(clip: torch.Tensor, width: int, height: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clip space -> pixel coordinates (D3D viewport transform, y flipped).
    Returns (xy_pixels, ndc_z, inv_w)."""
    inv_w = 1.0 / clip[..., 3]
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[..., 1] * 0.5) * height
    return torch.stack([sx, sy], dim=-1), ndc[..., 2], inv_w


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add rounds it,
    for float32 operands, with the same bits on every device. The float64
    product of two float32 values is exact; the float64 sum is taken to odd
    rounding (an even sum with a nonzero TwoSum error moves one ulp toward
    the exact sum), and a float64 rounded to odd rounds to float32 as the
    exact value would (53 >= 2 * 24 + 2 bits)."""
    q = a.double() * b
    s = q + c
    bb = s - q
    err = (q - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    step = (torch.sign(err) * torch.sign(s)).long() * (1 - (bits & 1))
    return (bits + step).view(torch.float64).float()


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded correctly, with the same bits on every
    device: PyTorch's float32 sqrt on the card is not always the correctly
    rounded one, its float64 sqrt is, and rounding that to float32 rounds
    as the exact root would (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).float()
