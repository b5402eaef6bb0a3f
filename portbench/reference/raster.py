"""Triangle setup: clipless homogeneous triangle setup (Olano & Greer)
with D3D conventions (pixel centres at (x+0.5, y+0.5), y down, ndc z in
[0, 1], clockwise-in-screen front faces, no top-left fill rule). The
rasterizer that takes it is ``raster_plain``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

F32_FAR = float(np.float32(3.0e38))


class TriSetup(NamedTuple):
    """Screen-space triangle setup over a flat triangle axis N.

    edge:   (N, 3, 3): 3 edges x (a, b, c), E(x, y) = a*x + b*y + c >= 0
            inside, gradient-normalized.
    planes: (N, C, 3): (a, b, c) planes for [z_ndc, inv_w, attr_0/w ...].
    bbox:   (N, 4): (x0, y0, x1, y1) inclusive pixel bounds.
    valid:  (N,) bool.
    """

    edge: torch.Tensor
    planes: torch.Tensor
    bbox: torch.Tensor
    valid: torch.Tensor


class TriComponents(NamedTuple):
    """Component-form setup: every field holds (I, T) maps.

    edge:  9 maps, e{0,1,2} x (a, b, c).
    quant: 2 + A tuples of 3 maps, (a, b, c) planes for
           [z_ndc, inv_w, attr_0/w .. attr_{A-1}/w].
    bbox:  4 maps, x0, y0, x1, y1.
    valid: (I, T) bool.
    vert_clip: 4 maps of (I, V), per-vertex clip (x, y, z, w).
    """

    edge: tuple
    quant: tuple
    bbox: tuple
    valid: torch.Tensor
    vert_clip: tuple


def setup_components(world: torch.Tensor, attrs: torch.Tensor,
                     inst_valid: torch.Tensor, tri_indices: torch.Tensor,
                     world_to_clip: torch.Tensor, width: int, height: int,
                     w_eps: float = 1e-4) -> TriComponents:
    """Project vertices and build per-triangle setup for I*T triangles.
    ``world`` is (I, V, 3) or the terrain lattice (I, S, S, 3); ``attrs``
    matches it with A channels (A = 0 for a depth-only raster);
    ``tri_indices`` (T, 3) index the V axis."""
    I = world.shape[0]
    A = attrs.shape[-1]
    verts = world.reshape(I, -1, 3)
    vattr = attrs.reshape(I, verts.shape[1], A)
    M = world_to_clip
    vx, vy, vz = verts[..., 0], verts[..., 1], verts[..., 2]
    cc = [vx * M[0, c] + vy * M[1, c] + vz * M[2, c] + M[3, c]
          for c in range(4)]

    T = tri_indices.shape[0]
    lattice = (world.ndim == 4 and world.shape[1] == world.shape[2]
               and T == (world.shape[1] - 1) ** 2 * 2)
    if lattice:
        S = world.shape[1]

        def vert(x, k):
            # make_grid order: per cell (row-major) tri A = (bl, tl, tr),
            # tri B = (bl, tr, br) (TerrainPass.cpp:79-85)
            g = x.reshape(I, S, S)
            bl, tl = g[:, :-1, :-1], g[:, 1:, :-1]
            tr, br = g[:, 1:, 1:], g[:, :-1, 1:]
            a = (bl, tl, tr)[k]
            b = (bl, tr, br)[k]
            return torch.stack([a, b], dim=3).reshape(I, T)
    else:
        def vert(x, k):
            return x[:, tri_indices[:, k]]

    w0, w1, w2 = vert(cc[3], 0), vert(cc[3], 1), vert(cc[3], 2)

    def vh(k):  # homogeneous screen row (Xh, Yh, w) of vertex k
        w = (w0, w1, w2)[k]
        return ((vert(cc[0], k) + w) * (0.5 * width),
                (w - vert(cc[1], k)) * (0.5 * height), w)

    a0, b0, c0 = vh(0)
    a1, b1, c1 = vh(1)
    a2, b2, c2 = vh(2)

    def cross3(ax, ay, az, bx, by, bz):
        return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)

    u0 = cross3(a1, b1, c1, a2, b2, c2)
    u1 = cross3(a2, b2, c2, a0, b0, c0)
    u2 = cross3(a0, b0, c0, a1, b1, c1)
    det = a0 * u0[0] + b0 * u0[1] + c0 * u0[2]
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det,
                                torch.ones_like(det))
    front = det < 0.0
    edge_maps = [-u0[0], -u0[1], -u0[2], -u1[0], -u1[1], -u1[2],
                 -u2[0], -u2[1], -u2[2]]

    # planes for [z_ndc, 1/w, attr/w]: the q*w vertex values are
    # (z_clip, 1, attr); coef_j = sum_v u_v[j] * q_v * inv_det
    def plane(q0, q1, q2):
        return tuple((u0[j] * q0 + u1[j] * q1 + u2[j] * q2) * inv_det
                     for j in range(3))

    ones = torch.ones_like(w0)
    quant = [plane(vert(cc[2], 0), vert(cc[2], 1), vert(cc[2], 2)),
             plane(ones, ones, ones)]
    for i in range(A):
        ai = vattr[..., i]
        quant.append(plane(vert(ai, 0), vert(ai, 1), vert(ai, 2)))

    # pixel bbox over in-front vertices; near-plane-crossing triangles get
    # the full frame; one pixel of conservative padding
    bh0, bh1, bh2 = w0 <= w_eps, w1 <= w_eps, w2 <= w_eps
    any_behind = bh0 | bh1 | bh2
    crossing = any_behind & ~(bh0 & bh1 & bh2)

    def safe(w, bh):
        return torch.where(bh, ones, w)

    xs0, xs1, xs2 = a0 / safe(w0, bh0), a1 / safe(w1, bh1), a2 / safe(w2, bh2)
    ys0, ys1, ys2 = b0 / safe(w0, bh0), b1 / safe(w1, bh1), b2 / safe(w2, bh2)
    bx0 = torch.clamp(torch.floor(torch.minimum(xs0, torch.minimum(xs1, xs2)))
                      - 1, 0, width - 1)
    by0 = torch.clamp(torch.floor(torch.minimum(ys0, torch.minimum(ys1, ys2)))
                      - 1, 0, height - 1)
    bx1 = torch.clamp(torch.ceil(torch.maximum(xs0, torch.maximum(xs1, xs2)))
                      + 1, 0, width - 1)
    by1 = torch.clamp(torch.ceil(torch.maximum(ys0, torch.maximum(ys1, ys2)))
                      + 1, 0, height - 1)
    zero = torch.zeros_like(bx0)
    bbox_maps = (torch.where(crossing, zero, bx0),
                 torch.where(crossing, zero, by0),
                 torch.where(crossing, zero + (width - 1), bx1),
                 torch.where(crossing, zero + (height - 1), by1))
    on_screen = (bx1 >= bx0) & (by1 >= by0)

    # degeneracy guard: in-front triangles use the exact pixel-space area
    # (front = area2 < -1e-12); crossing ones keep the det sign
    area2 = (xs1 - xs0) * (ys2 - ys0) - (xs2 - xs0) * (ys1 - ys0)
    front = torch.where(crossing, front, area2 < -1e-12)

    finite = torch.isfinite(det)
    for q in quant:
        for m in q:
            finite = finite & torch.isfinite(m)
    for u in (u0, u1, u2):
        for c in range(3):
            finite = finite & torch.isfinite(u[c])
    valid = (front & finite & inst_valid[:, None]
             & (crossing | (~any_behind & on_screen)))

    # normalize each edge by its gradient magnitude (signed pixel distance)
    norm_edges = []
    for e in range(3):
        ea, eb, ec = edge_maps[3 * e:3 * e + 3]
        g = torch.clamp(torch.sqrt(ea * ea + eb * eb), min=1e-20)
        norm_edges += [ea / g, eb / g, ec / g]

    return TriComponents(edge=tuple(norm_edges), quant=tuple(quant),
                         bbox=bbox_maps, valid=valid, vert_clip=tuple(cc))


def stack_components(comp: TriComponents) -> TriSetup:
    """Component form -> stacked TriSetup over the flat I*T triangle axis."""
    I, T = comp.valid.shape
    edges = torch.stack(comp.edge, dim=-1).reshape(I * T, 3, 3)
    coefs = [m for q in comp.quant for m in q]
    planes = torch.stack(coefs, dim=-1).reshape(I * T, len(comp.quant), 3)
    bbox = torch.stack(comp.bbox, dim=-1).reshape(I * T, 4)
    return TriSetup(edge=edges, planes=planes, bbox=bbox,
                    valid=comp.valid.reshape(I * T))


def setup_triangles(world, attrs, inst_valid, tri_indices, world_to_clip,
                    width: int, height: int, w_eps: float = 1e-4) -> TriSetup:
    """``setup_components`` stacked into a TriSetup."""
    return stack_components(setup_components(world, attrs, inst_valid,
                                             tri_indices, world_to_clip,
                                             width, height, w_eps))
