"""Bilinear texture sampling with clamp addressing, as in
``vrenderer_tpu.ops.texture``. Two texel modes: "lattice" (texel centres
at integer coordinates under ``uv * (size - 1)``, the default) and "d3d",
the reference's hardware convention (centres at half-integers under
``uv * size - 0.5``, border clamp: SampleLevel with a linear-clamp
sampler, terrain_vs.hlsl:32), selected per world by
``TerrainSettings.uv_mode``.

The separable grid sampler keeps the JAX package's form, two float32
matrix products with a bilinear weight matrix, because the vertex stage
samples whole per-instance lattices at once and the products are exact in
float32. ``sample_points`` is the per-point gather.
"""

from __future__ import annotations

import torch


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


def sample_separable(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     mode: str = "lattice") -> torch.Tensor:
    """Sample ``tex`` (H, W) or (H, W, C) on the grid v x u; u (..., nu),
    v (..., nv). Returns (..., nv, nu) or (..., nv, nu, C)."""
    H, W = tex.shape[0], tex.shape[1]
    au = interp_matrix(u, W, mode)
    av = interp_matrix(v, H, mode)
    if tex.ndim == 2:
        tmp = torch.einsum("...vh,hw->...vw", av, tex)
        return torch.einsum("...vw,...uw->...vu", tmp, au)
    tmp = torch.einsum("...vh,hwc->...vwc", av, tex)
    return torch.einsum("...vwc,...uw->...vuc", tmp, au)


def sample_points_matmul(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         mode: str = "lattice") -> torch.Tensor:
    """Bilinear samples at arbitrary points (n,) via a row matmul and a
    weighted column reduce. Returns (n,) or (n, C)."""
    H, W = tex.shape[0], tex.shape[1]
    av = interp_matrix(v, H, mode)
    au = interp_matrix(u, W, mode)
    if tex.ndim == 2:
        return torch.sum((av @ tex) * au, dim=-1)
    tmp = torch.einsum("nh,hwc->nwc", av, tex)
    return torch.sum(tmp * au[..., None], dim=1)


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
