"""Triangle meshes: the scene-geometry path (Renderer.cpp:384-399).

As in ``vrenderer_tpu.models.mesh``, a mesh is a bundle of tensors and
rides the terrain's rasterizer as extra instance blocks of
``tris_per_instance`` triangles, padded with degenerate triangles.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from vrenderer_tpu_torch.utils import math3d


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


def subdivide_to_texel_density(pos: np.ndarray, attrs: list, uv: np.ndarray,
                               tris: np.ndarray, tex_shape,
                               target_texels: float = 1.0,
                               max_tris: int = 1 << 18):
    """Midpoint-subdivide triangles until every edge spans at most
    ``target_texels`` texels of an (H, W) texture in uv space, so that
    colours baked to vertices reach the texture's texel density (the frame
    interpolates vertex attributes; the reference samples per pixel,
    Renderer.cpp:384-399).

    Host numpy in float64, as in ``vrenderer_tpu.models.mesh``, with the
    same operations in the same order, so both packages give the same
    arrays. An edge is marked iff its own texel length exceeds the target,
    so both triangles sharing it agree and the mesh stays crack-free; a
    triangle with 1, 2 or 3 marked edges splits into 2, 3 or 4. If the
    next round would pass ``max_tris`` refinement stops with a warning
    that gives the achieved texels per edge. ``attrs`` is a list of (V, C)
    arrays carried through the splits (midpoints average linearly).
    Returns (pos, attrs, uv, tris, achieved worst edge in texels)."""
    pos = np.asarray(pos, np.float64)
    uv = np.asarray(uv, np.float64)
    tris = np.asarray(tris, np.int64)
    attrs = [np.asarray(a, np.float64) for a in attrs]
    H, W = int(tex_shape[0]), int(tex_shape[1])
    scale = np.asarray([W - 1, H - 1], np.float64)

    def edge_texels(a, b):
        return np.linalg.norm((uv[a] - uv[b]) * scale, axis=1)

    capped = False
    while True:
        v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
        mk = np.stack([edge_texels(v0, v1) > target_texels,
                       edge_texels(v1, v2) > target_texels,
                       edge_texels(v2, v0) > target_texels], axis=1)
        n_marked = mk.sum(axis=1)
        if not n_marked.any():
            break
        if len(tris) + int(n_marked.sum()) > max_tris:
            capped = True
            break
        # rotate each triangle's vertices so its marks read (1,0,0),
        # (1,1,0) or (1,1,1): edge i is (v_i, v_i+1)
        rot = np.zeros(len(tris), np.int64)
        rot[(~mk[:, 0]) & mk[:, 1]] = 1
        rot[(~mk[:, 0]) & (~mk[:, 1]) & mk[:, 2]] = 2
        rot[mk[:, 0] & (~mk[:, 1]) & mk[:, 2]] = 2
        vs = np.stack([v0, v1, v2], axis=1)
        ar = np.arange(len(tris))[:, None]
        vs = vs[ar, (np.arange(3)[None, :] + rot[:, None]) % 3]
        mkr = mk[ar, (np.arange(3)[None, :] + rot[:, None]) % 3]

        # one midpoint vertex per marked undirected edge
        em = np.concatenate([vs[mkr[:, 0]][:, [0, 1]],
                             vs[mkr[:, 1]][:, [1, 2]],
                             vs[mkr[:, 2]][:, [2, 0]]], axis=0)
        uniq, inv = np.unique(np.sort(em, axis=1), axis=0,
                              return_inverse=True)
        base = len(pos)
        pos = np.concatenate([pos, 0.5 * (pos[uniq[:, 0]] + pos[uniq[:, 1]])])
        uv = np.concatenate([uv, 0.5 * (uv[uniq[:, 0]] + uv[uniq[:, 1]])])
        attrs = [np.concatenate([a, 0.5 * (a[uniq[:, 0]] + a[uniq[:, 1]])])
                 for a in attrs]
        mid = np.full((len(tris), 3), -1, np.int64)
        off = 0
        for e_i in range(3):
            n_e = int(mkr[:, e_i].sum())
            mid[mkr[:, e_i], e_i] = base + inv[off:off + n_e]
            off += n_e

        a, b, c = vs[:, 0], vs[:, 1], vs[:, 2]
        mab, mbc, mca = mid[:, 0], mid[:, 1], mid[:, 2]
        out = [tris[n_marked == 0]]
        s1 = mkr[:, 0] & ~mkr[:, 1] & ~mkr[:, 2]
        if s1.any():
            out.append(np.stack([a[s1], mab[s1], c[s1]], axis=1))
            out.append(np.stack([mab[s1], b[s1], c[s1]], axis=1))
        s2 = mkr[:, 0] & mkr[:, 1] & ~mkr[:, 2]
        if s2.any():
            out.append(np.stack([mab[s2], b[s2], mbc[s2]], axis=1))
            out.append(np.stack([a[s2], mab[s2], mbc[s2]], axis=1))
            out.append(np.stack([a[s2], mbc[s2], c[s2]], axis=1))
        s3 = n_marked == 3
        if s3.any():
            out.append(np.stack([a[s3], mab[s3], mca[s3]], axis=1))
            out.append(np.stack([mab[s3], b[s3], mbc[s3]], axis=1))
            out.append(np.stack([mca[s3], mbc[s3], c[s3]], axis=1))
            out.append(np.stack([mab[s3], mbc[s3], mca[s3]], axis=1))
        tris = np.concatenate(out, axis=0)

    achieved = float(np.max([
        edge_texels(tris[:, 0], tris[:, 1]).max(initial=0.0),
        edge_texels(tris[:, 1], tris[:, 2]).max(initial=0.0),
        edge_texels(tris[:, 2], tris[:, 0]).max(initial=0.0)]))
    if capped:
        warnings.warn(
            f"subdivide_to_texel_density: stopped at max_tris={max_tris} "
            f"before reaching {target_texels:g} texels/edge for a {W}x{H} "
            f"texture — worst edge still spans {achieved:.1f} texels; baked "
            f"vertex colors will be under-resolved there (raise max_tris or "
            f"use a smaller texture).")
    return pos, attrs, uv, tris, achieved


def transform_mesh(mesh: Mesh, affine: torch.Tensor) -> Mesh:
    """Apply a (4, 3) row-vector affine; normals by inv(L)^T."""
    pos = math3d.affine_apply(affine, mesh.positions)
    lin_inv_t = torch.linalg.inv(affine[:3, :]).T
    nrm = math3d.normalize(mesh.normals @ lin_inv_t)
    return mesh._replace(positions=pos, normals=nrm)


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
