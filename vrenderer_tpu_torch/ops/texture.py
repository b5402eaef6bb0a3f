"""Bilinear texture sampling with clamp addressing, as in
``vrenderer_tpu.ops.texture``. Two texel modes: "lattice" (texel centres
at integer coordinates under ``uv * (size - 1)``, the default) and "d3d",
the reference's hardware convention (centres at half-integers under
``uv * size - 0.5``, border clamp: SampleLevel with a linear-clamp
sampler, terrain_vs.hlsl:32), selected per world by
``TerrainSettings.uv_mode``.

The JAX package samples grids (``sample_separable``) and scattered points
(``sample_points_matmul``) as float32 matrix products with a bilinear
weight matrix ``interp_matrix``, whose rows have two nonzero taps.
PyTorch's CPU product accumulates the taps in ascending texel order with
one fused multiply-add, fl(w1 a1 + fl(w0 a0)) (so does JAX's, but for the
column product of a 2-D grid, which rounds both products: ROADMAP C); a
matrix product on the card sums in its library's own order, which nothing
pins. Here both samplers gather the two taps of each axis
(``bilinear_taps``) and form that fused multiply-add elementwise
(``math3d.fma32``), so every device returns the CPU product's bits, on
which selection and binning depend. ``sample_points`` is the per-point
gather with its own (lerp) rounding.
"""

from __future__ import annotations

import torch

from vrenderer_tpu_torch.utils import math3d


def texel_coords(u: torch.Tensor, size: int, mode: str = "lattice"
                 ) -> torch.Tensor:
    """uv in [0, 1] -> continuous texel coordinate with clamp addressing."""
    if mode == "d3d":
        # clamping the continuous coordinate to [0, size-1] gives border
        # addressing for the two bilinear taps
        return torch.clamp(u * size - 0.5, 0.0, size - 1)
    if mode != "lattice":
        raise ValueError(f"unknown texel addressing mode {mode!r}")
    return torch.clamp(u, 0.0, 1.0) * (size - 1)


def interp_matrix(u: torch.Tensor, size: int, mode: str = "lattice"
                  ) -> torch.Tensor:
    """Bilinear weights (..., n, size): w[i, t] is texel t's weight for
    sample u[i]."""
    x = texel_coords(u, size, mode)
    t = torch.arange(size, dtype=x.dtype, device=x.device)
    return torch.clamp(1.0 - torch.abs(x[..., :, None] - t), min=0.0)


def bilinear_taps(u: torch.Tensor, size: int, mode: str = "lattice"):
    """The two clamped texels (i0, i1) of each sample and the weights
    ``interp_matrix`` gives them, rounded as its |x - t| weights are:
    w0 = 1 - (x - i0), w1 = 1 - ((i0 + 1) - x). At the upper edge i1 = i0
    and w1 = 0, where the matrix has no second tap."""
    x = texel_coords(u, size, mode)
    i0 = torch.floor(x)
    w0 = 1.0 - (x - i0)
    w1 = 1.0 - ((i0 + 1.0) - x)
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=size - 1), w0, w1


def _corners(tex: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
             ) -> torch.Tensor:
    """tex at every (row of ``ys``, column of ``xs``) pair, one gather:
    ys (2, ...), xs (2, ...) broadcastable -> (2, 2, ...[, C])."""
    H, W = tex.shape[0], tex.shape[1]
    idx = ys[:, None] * W + xs[None, :]
    return tex.reshape(H * W, *tex.shape[2:])[idx]


def sample_separable(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     mode: str = "lattice") -> torch.Tensor:
    """Sample ``tex`` (H, W) or (H, W, C) on the grid v x u; u (..., nu),
    v (..., nv). Returns (..., nv, nu) or (..., nv, nu, C): the bits of
    the two products A_v T A_u^T (rows, then columns) as PyTorch's CPU
    forms them, each one fused multiply-add over its two taps."""
    H, W = tex.shape[0], tex.shape[1]
    y0, y1, wy0, wy1 = bilinear_taps(v, H, mode)
    x0, x1, wx0, wx1 = bilinear_taps(u, W, mode)
    ch = (None,) * (tex.ndim - 2)
    wy0, wy1 = (w[(..., slice(None), None) + ch] for w in (wy0, wy1))
    wx0, wx1 = (w[(..., None, slice(None)) + ch] for w in (wx0, wx1))
    # (row tap, column tap, ..., nv, nu[, C])
    t = _corners(tex, torch.stack([y0, y1])[..., :, None],
                 torch.stack([x0, x1])[..., None, :])
    # each product's accumulator starts at +0.0, as the matrix product's
    # does (a -0.0 texel gives +0.0 there)
    rows = math3d.fma32(wy1, t[1], wy0 * t[0] + 0.0)   # at columns x0, x1
    return math3d.fma32(wx1, rows[1], wx0 * rows[0] + 0.0)


def sample_points_matmul(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         mode: str = "lattice") -> torch.Tensor:
    """Bilinear samples at points (n,): the bits of the JAX package's row
    product (one fused multiply-add over the two row taps) and weighted
    column sum (two rounded products, added). Returns (n,) or (n, C)."""
    H, W = tex.shape[0], tex.shape[1]
    y0, y1, wy0, wy1 = bilinear_taps(v, H, mode)
    x0, x1, wx0, wx1 = bilinear_taps(u, W, mode)
    ch = (None,) * (tex.ndim - 2)
    wy0, wy1, wx0, wx1 = (w[(...,) + ch] for w in (wy0, wy1, wx0, wx1))
    t = _corners(tex, torch.stack([y0, y1]), torch.stack([x0, x1]))
    rows = math3d.fma32(wy1, t[1], wy0 * t[0] + 0.0)
    return rows[0] * wx0 + rows[1] * wx1


def sample_points(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  mode: str = "lattice") -> torch.Tensor:
    """Bilinear samples at arbitrary points via gather. tex (H, W) or
    (H, W, C); u, v (...). Returns (...) or (..., C)."""
    H, W = tex.shape[0], tex.shape[1]
    x = texel_coords(u, W, mode)
    y = texel_coords(v, H, mode)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = x - x0
    fy = y - y0
    if tex.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    a, b = tex[y0, x0], tex[y0, x1]
    c, d = tex[y1, x0], tex[y1, x1]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


def world_to_uv(world_xz: torch.Tensor, world_size: float) -> torch.Tensor:
    """uv = (worldPos.xz + worldSize/2) / worldSize (terrain_vs.hlsl:29-30)."""
    return (world_xz + world_size * 0.5) / world_size
