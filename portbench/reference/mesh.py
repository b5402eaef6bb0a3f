"""Triangle meshes: the scene-geometry path (Renderer.cpp:384-399).

As in ``vrenderer_tpu.models.mesh``, a mesh is a bundle of tensors and
rides the terrain's rasterizer as extra instance blocks of
``tris_per_instance`` triangles, padded with degenerate triangles.
"""

from __future__ import annotations


from typing import NamedTuple

import numpy as np
import torch


class Mesh(NamedTuple):
    positions: torch.Tensor  # (V, 3)
    normals: torch.Tensor    # (V, 3)
    colors: torch.Tensor     # (V, 3) linear base colour
    tris: torch.Tensor       # (T, 3) int64

    @property
    def num_tris(self) -> int:
        return self.tris.shape[0]


def cube(size: float = 1.0, color=(0.8, 0.2, 0.2), device=None) -> Mesh:
    """Cube with split normals (24 vertices, 12 triangles), outward faces
    front-facing; the stand-in for the reference's Cube.gltf
    (main.cpp:89-95)."""
    s = size * 0.5
    faces = [
        ((0, 0, 1), [(-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]),
        ((0, 0, -1), [(s, -s, -s), (-s, -s, -s), (-s, s, -s), (s, s, -s)]),
        ((1, 0, 0), [(s, -s, s), (s, -s, -s), (s, s, -s), (s, s, s)]),
        ((-1, 0, 0), [(-s, -s, -s), (-s, -s, s), (-s, s, s), (-s, s, -s)]),
        ((0, 1, 0), [(-s, s, s), (s, s, s), (s, s, -s), (-s, s, -s)]),
        ((0, -1, 0), [(-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s)]),
    ]
    pos, nrm, tris = [], [], []
    for n, corners in faces:
        base = len(pos)
        pos.extend(corners)
        nrm.extend([n] * 4)
        tris.append([base, base + 1, base + 2])
        tris.append([base, base + 2, base + 3])
    col = np.tile(np.asarray(color, np.float32), (len(pos), 1))

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return Mesh(positions=t(pos), normals=t(nrm), colors=t(col),
                tris=t(tris, torch.int64))


def mesh_to_blocks(mesh: Mesh, tris_per_block: int, max_height: torch.Tensor,
                   num_attrs: int = 8):
    """Chunk a mesh into rasterizer instance blocks.

    Returns (world (B, 3*tpb, 3), attrs (B, 3*tpb, A), tri_idx (tpb, 3),
    valid (B,)): every triangle carries its own three vertices, padding
    triangles are degenerate (all vertices at 0) and culled by setup, and
    attrs use the channel layout albedo3, normal3, shadow, height01."""
    T = mesh.num_tris
    tpb = tris_per_block
    nb = -(-T // tpb)
    pad = nb * tpb - T
    flat = mesh.tris.reshape(-1)

    def padv(x):
        z = torch.zeros((3 * pad, x.shape[1]), dtype=x.dtype, device=x.device)
        return torch.cat([x[flat], z]).reshape(nb, 3 * tpb, x.shape[1])

    tri_pos, tri_nrm, tri_col = (padv(mesh.positions), padv(mesh.normals),
                                 padv(mesh.colors))
    shad = torch.ones(tri_pos.shape[:2], dtype=torch.float32,
                      device=tri_pos.device)
    h01 = tri_pos[..., 1] / torch.clamp(max_height, min=1e-6)
    attrs = torch.cat([tri_col, tri_nrm, shad[..., None], h01[..., None]],
                      dim=-1)
    idx = torch.arange(tpb * 3, device=tri_pos.device).reshape(tpb, 3)
    valid = torch.ones((nb,), dtype=torch.bool, device=tri_pos.device)
    return tri_pos, attrs, idx, valid
