"""Heightmap and albedo assets: value-noise fBm with a dome falloff,
quantized like an 8-bit PNG, built in numpy from its seed and returned as
a float32 tensor on ``device``; its albedo ramp. The benchmark makes the
terrain here and hands the same tensors to the program and the
reference.
"""

from __future__ import annotations


import numpy as np
import torch


def _smoothstep(t: np.ndarray) -> np.ndarray:
    return t * t * (3.0 - 2.0 * t)


def _value_noise(res: int, cells: int, rng: np.random.Generator) -> np.ndarray:
    """One octave of value noise on a res x res grid."""
    lattice = rng.random((cells + 1, cells + 1), dtype=np.float32)
    u = np.linspace(0.0, cells, res, endpoint=False, dtype=np.float32)
    i0 = np.floor(u).astype(np.int32)
    f = _smoothstep(u - i0)
    i1 = np.minimum(i0 + 1, cells)
    rows = (
        lattice[i0][:, i0] * (1 - f)[None, :] + lattice[i0][:, i1] * f[None, :]
    )
    rows1 = (
        lattice[i1][:, i0] * (1 - f)[None, :] + lattice[i1][:, i1] * f[None, :]
    )
    return rows * (1 - f)[:, None] + rows1 * f[:, None]


def procedural_heightmap(resolution: int = 256, seed: int = 1234,
                         device=None) -> torch.Tensor:
    """Deterministic fBm heightfield in [0, 1], (res, res) float32, indexed
    [v, u] = [z row, x column] (terrain_vs.hlsl:30)."""
    if resolution >= 1024:
        raise ValueError("the reference makes the numpy value-noise fields "
                         "(resolution below 1024) only")
    rng = np.random.default_rng(seed)
    h = np.zeros((resolution, resolution), np.float32)
    amp, cells, total = 1.0, 4, 0.0
    while cells <= resolution // 2:
        h += amp * _value_noise(resolution, cells, rng)
        total += amp
        amp *= 0.55
        cells *= 2
    h = h / total
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, resolution, dtype=np.float32),
        np.linspace(-1, 1, resolution, dtype=np.float32),
        indexing="ij",
    )
    dome = np.clip(1.0 - 0.55 * (xx * xx + yy * yy), 0.0, 1.0)
    h = np.clip(h * (0.35 + 0.65 * dome), 0.0, 1.0)
    h = np.round(h * 255.0) / 255.0
    return torch.as_tensor(h.astype(np.float32), device=device)


def procedural_albedo(height01: torch.Tensor) -> torch.Tensor:
    """Grass -> rock -> snow albedo ramp (res, res, 3) from the height
    field, on the height field's device."""
    h = height01.detach().cpu().numpy()
    grass = np.array([0.13, 0.35, 0.11], np.float32)
    rock = np.array([0.35, 0.30, 0.26], np.float32)
    snow = np.array([0.85, 0.87, 0.90], np.float32)
    t1 = np.clip((h - 0.25) / 0.35, 0.0, 1.0)[..., None]
    t2 = np.clip((h - 0.65) / 0.2, 0.0, 1.0)[..., None]
    c = grass * (1 - t1) + rock * t1
    c = c * (1 - t2) + snow * t2
    return torch.as_tensor(c.astype(np.float32), device=height01.device)
