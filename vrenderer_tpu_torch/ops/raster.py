"""Triangle setup and the brute-force oracle rasterizer.

Ports ``vrenderer_tpu.ops.raster``: clipless homogeneous triangle setup
(Olano & Greer) with D3D conventions (pixel centres at (x+0.5, y+0.5),
y down, ndc z in [0, 1], clockwise-in-screen front faces, no top-left fill
rule), and ``rasterize_xla``, the dense every-tile-times-every-triangle
rasterizer that is the CPU oracle for tests. The binned fast path that the
renderer uses is ``ops/raster_cuda.py``.
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
    """Stacked-tensor setup (``stack_components(setup_components(...))``)."""
    return stack_components(setup_components(
        world, attrs, inst_valid, tri_indices, world_to_clip, width, height,
        w_eps))


def shift_setup_y(setup: TriSetup, y0: float) -> TriSetup:
    """Rebase a stacked setup's screen coefficients to the band that starts
    at frame row ``y0``: every E(x, y) = a x + b y + c becomes
    E'(x, y') = a x + b y' + (c + b y0), and the bbox rows shift by -y0.
    The product and the sum are two operations, each rounded once, as in
    the JAX package (one fused multiply-add would move exact silhouette
    pixels)."""
    edge = setup.edge.clone()
    edge[..., 2] = setup.edge[..., 2] + setup.edge[..., 1] * y0
    planes = setup.planes.clone()
    planes[..., 2] = setup.planes[..., 2] + setup.planes[..., 1] * y0
    bbox = setup.bbox - setup.bbox.new_tensor([0.0, y0, 0.0, y0])
    return TriSetup(edge=edge, planes=planes, bbox=bbox, valid=setup.valid)


def shift_components_y(comp: TriComponents, y0: float) -> TriComponents:
    """``shift_setup_y`` on the component form. ``vert_clip`` stays: the
    instance bounds are taken from it before the shift."""
    e = list(comp.edge)
    for k in range(3):
        e[3 * k + 2] = e[3 * k + 2] + e[3 * k + 1] * y0
    quant = tuple((a, b, c + b * y0) for a, b, c in comp.quant)
    x0, by0, x1, by1 = comp.bbox
    return TriComponents(edge=tuple(e), quant=quant,
                         bbox=(x0, by0 - y0, x1, by1 - y0), valid=comp.valid,
                         vert_clip=comp.vert_clip)


def _affine(coef: torch.Tensor, px: torch.Tensor, py: torch.Tensor
            ) -> torch.Tensor:
    """a*px + b*py + c, left to right, one rounding per operation."""
    return coef[..., 0:1] * px + coef[..., 1:2] * py + coef[..., 2:3]


def rasterize_xla(setup: TriSetup, width: int, height: int,
                  batch: int = 128, reverse_z: bool = False,
                  wire_px: float = 0.0):
    """Brute-force oracle (raster.py:391-556 of the JAX package): every
    triangle batch is tested against every pixel of the batch's bbox union
    (no pixel outside a triangle's bbox can be covered); within a batch the
    minimum z wins (the maximum under ``reverse_z``) with ties to the
    lowest id, across batches ties keep the lower id. ``wire_px > 0`` is
    the wireframe fill mode: a pixel covers only within ``wire_px`` of an
    edge. Then the winners' attribute planes are evaluated and
    perspective-divided. Returns (z (H, W), F32_FAR where uncovered,
    -F32_FAR under ``reverse_z``; id (H, W) int32, -1 uncovered;
    attrs (H, W, A))."""
    dev = setup.edge.device
    n = setup.edge.shape[0]
    C = setup.planes.shape[1]
    worst = -F32_FAR if reverse_z else F32_FAR
    z = torch.full((height, width), worst, dtype=torch.float32, device=dev)
    idb = torch.full((height, width), 2**31 - 1, dtype=torch.int32,
                     device=dev)
    acc = torch.zeros((height, width, C - 1), dtype=torch.float32, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    live_tris = setup.valid.nonzero()[:, 0]
    batches = []
    for s in range(0, live_tris.shape[0], batch):
        sel = live_tris[s:s + batch]
        bb = setup.bbox[sel]
        lo, hi = bb.amin(0), bb.amax(0)
        x0, y0, x1, y1 = (int(v) for v in
                          torch.stack([lo[0], lo[1], hi[2], hi[3]]).tolist())
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, width - 1), min(y1, height - 1)
        if x1 < x0 or y1 < y0:
            continue
        ys = torch.arange(y0, y1 + 1, dtype=torch.float32, device=dev) + 0.5
        xs = torch.arange(x0, x1 + 1, dtype=torch.float32, device=dev) + 0.5
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        px, py = xx.reshape(1, -1), yy.reshape(1, -1)
        win = (slice(y0, y1 + 1), slice(x0, x1 + 1))
        batches.append((sel, px, py, win))

        B, P = sel.shape[0], px.shape[1]
        ev = _affine(setup.edge[sel].reshape(-1, 3), px, py).reshape(B, 3, P)
        zv = _affine(setup.planes[sel, 0, :], px, py)
        cover = (torch.all(ev >= 0.0, dim=1) & (zv >= 0.0) & (zv <= 1.01)
                 & (px >= bb[:, 0:1] + 0.5) & (px <= bb[:, 2:3] + 0.5)
                 & (py >= bb[:, 1:2] + 0.5) & (py <= bb[:, 3:4] + 0.5))
        if wire_px > 0.0:
            cover &= torch.amin(ev, dim=1) <= wire_px
        zv = torch.where(cover, zv, torch.full_like(zv, worst))
        best = (torch.argmax(zv, dim=0) if reverse_z
                else torch.argmin(zv, dim=0))
        z_b = torch.gather(zv, 0, best[None, :])[0]
        id_b = ids[sel][best]
        zw, iw = z[win].reshape(-1), idb[win].reshape(-1)
        nearer = (z_b > zw) if reverse_z else (z_b < zw)
        upd = nearer | ((z_b == zw) & (id_b < iw))
        z[win] = torch.where(upd, z_b, zw).reshape(z[win].shape)
        idb[win] = torch.where(upd, id_b, iw).reshape(idb[win].shape)
    idb = torch.where(z == worst, torch.full_like(idb, -1), idb)

    for sel, px, py, win in batches:
        B, P = sel.shape[0], px.shape[1]
        vals = _affine(setup.planes[sel, 1:, :].reshape(-1, 3), px, py)
        vals = vals.reshape(B, C - 1, P)
        mask = ids[sel][:, None] == idb[win].reshape(1, -1)
        hit = torch.sum(torch.where(mask[:, None, :], vals,
                                    torch.zeros_like(vals)), dim=0)
        acc[win] = acc[win] + hit.T.reshape(acc[win].shape)
    inv_w = acc[..., 0:1]
    denom = torch.where(torch.abs(inv_w) > 1e-20, inv_w,
                        torch.ones_like(inv_w))
    return z, idb, acc[..., 1:] / denom
