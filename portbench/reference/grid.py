"""Shared terrain patch grid mesh (TerrainPass.cpp:52-87)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def make_grid(grid_size: int = 32, device=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (positions (S*S, 3) float32, indices (T, 3) int64),
    S = grid_size + 1: row-major over z then x in [-1, 1], triangles
    (bl, tl, tr) and (bl, tr, br) per cell."""
    side = grid_size + 1
    half = grid_size // 2
    coords = np.arange(-half, half + 1, dtype=np.float32) / half
    hh, ww = np.meshgrid(coords, coords, indexing="ij")
    pos = np.stack([ww, np.zeros_like(ww), hh], axis=-1).reshape(-1, 3)

    i = np.arange(side - 1)
    ii, jj = np.meshgrid(i, i, indexing="ij")
    bl = ii * side + jj
    tl = (ii + 1) * side + jj
    tr = (ii + 1) * side + jj + 1
    br = ii * side + jj + 1
    tris = np.stack(
        [np.stack([bl, tl, tr], axis=-1), np.stack([bl, tr, br], axis=-1)],
        axis=-2,
    ).reshape(-1, 3)
    return (torch.as_tensor(pos, device=device),
            torch.as_tensor(tris.astype(np.int64), device=device))
