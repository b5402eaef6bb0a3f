"""Deferred lighting, tonemapping, sky and sRGB encode: image-space
elementwise passes, ported from ``vrenderer_tpu.ops.lighting``.

* ``deferred_lighting``: one directional light with a shadow term plus a
  hemispherical ambient, bottom = top * (0.3, 0.4, 0.3)
  (Renderer.cpp:417-428), and a GGX specular lobe at the terrain's
  f0 = 0.01, roughness = 1 (terrain_ps.hlsl:76-79).
* ``tonemap``: exposure + luminance Reinhard (or ACES / clamp).
* ``adapt_exposure``: eye adaptation, the exposure scale ``tonemap`` is
  given when the frame adapts (Renderer.cpp:188-189), split at its one
  whole-frame statistic (``luminance_sums``, ``adapt_from_sums``) for
  frames rendered in screen bands.
* ``sky_color``: drawn after tonemapping, as the reference does
  (Renderer.cpp:430-439).
"""

from __future__ import annotations

import math

import torch

from vrenderer_tpu_torch.profiler import sync_copy
from vrenderer_tpu_torch.utils import math3d


def _vec3(values, like: torch.Tensor) -> torch.Tensor:
    return sync_copy(torch.tensor(values, dtype=torch.float32), like.device)


def ambient_color(normal_y: torch.Tensor, ambient_top: torch.Tensor
                  ) -> torch.Tensor:
    """lerp(bottom, top, n.y * 0.5 + 0.5), bottom = top * (0.3, 0.4, 0.3)."""
    top = ambient_top * torch.ones(normal_y.shape + (3,), dtype=torch.float32,
                                   device=normal_y.device)
    bottom = top * _vec3([0.3, 0.4, 0.3], normal_y)
    t = (normal_y * 0.5 + 0.5)[..., None]
    return bottom * (1.0 - t) + top * t


def deferred_lighting(albedo, normal, shadow, covered, view_dir,
                      light_direction, light_irradiance, light_color,
                      ambient_top, specular_f0: float = 0.01,
                      roughness: float = 1.0) -> torch.Tensor:
    """HDR colour (H, W, 3); background pixels are 0."""
    n = math3d.normalize(normal)
    l = -light_direction
    l = l / torch.sqrt(torch.sum(l * l) + 1e-20)
    ndotl = torch.clamp(torch.sum(n * l, dim=-1), 0.0, 1.0)

    radiance = light_color * light_irradiance * (ndotl * shadow)[..., None]
    diffuse = albedo * (radiance + ambient_color(n[..., 1], ambient_top))

    h = math3d.normalize(l + view_dir)
    ndoth = torch.clamp(torch.sum(n * h, dim=-1), 0.0, 1.0)
    ndotv = torch.clamp(torch.sum(n * view_dir, dim=-1), 1e-4, 1.0)
    a2 = roughness ** 4
    d = a2 / torch.clamp(math.pi * (ndoth * ndoth * (a2 - 1.0) + 1.0) ** 2,
                         min=1e-6)
    vis = 0.25 / torch.clamp(
        (ndotv + torch.sqrt(a2 + (1 - a2) * ndotv * ndotv))
        * (ndotl + torch.sqrt(a2 + (1 - a2) * ndotl * ndotl)),
        min=1e-4,
    )
    vdoth = torch.clamp(torch.sum(view_dir * h, dim=-1), 0.0, 1.0)
    fresnel = specular_f0 + (1.0 - specular_f0) * (1.0 - vdoth) ** 5
    spec = (d * vis * fresnel * ndotl * shadow * light_irradiance)[..., None]

    hdr = diffuse + spec * light_color
    return torch.where(covered[..., None], hdr, torch.zeros_like(hdr))


def tonemap(hdr: torch.Tensor, exposure=1.0, operator: str = "reinhard"
            ) -> torch.Tensor:
    """HDR -> linear LDR in [0, 1]."""
    c = hdr * exposure
    if operator == "clamp":
        return torch.clamp(c, 0.0, 1.0)
    if operator == "aces":
        a, b, cc, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        return torch.clamp((c * (a * c + b)) / (c * (cc * c + d) + e),
                           0.0, 1.0)
    lum = torch.clamp(
        0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2], min=1e-6
    )
    scale = (lum / (1.0 + lum)) / lum
    return torch.clamp(c * scale[..., None], 0.0, 1.0)


def luminance_sums(hdr: torch.Tensor, covered: torch.Tensor
                   ) -> torch.Tensor:
    """The whole-frame statistic of eye adaptation over an image or a
    screen band of one: (2,) float32, the covered pixels' count and the sum
    of their log2 luminance. The bands of a frame add theirs (in band
    order) into the frame's pair."""
    lum = 0.2126 * hdr[..., 0] + 0.7152 * hdr[..., 1] + 0.0722 * hdr[..., 2]
    logl = torch.log2(torch.clamp(lum, min=1e-6))
    n_cov = covered.sum(dtype=torch.float32)
    s_log = torch.where(covered, logl, torch.zeros_like(logl)).sum()
    return torch.stack([n_cov, s_log])


def adapt_from_sums(sums: torch.Tensor, adapted_lum: torch.Tensor,
                    dt: float, speed_up: float = 1.0,
                    speed_down: float = 1.0, min_lum: float = 0.02,
                    max_lum: float = 4.0, middle_grey: float = 0.5):
    """Eye adaptation from a frame's ``luminance_sums``: (new adapted
    luminance, exposure scale), () tensors on the sums' device. The
    geometric mean luminance of the covered pixels, approached
    exponentially at separate up and down rates over ``dt`` seconds and
    clamped to [min_lum, max_lum]; the scale is ``middle_grey / new``."""
    n_cov, s_log = sums[0], sums[1]
    target = torch.exp2(s_log / torch.clamp(n_cov, min=1.0))
    target = torch.clamp(target, min_lum, max_lum)
    speed = torch.where(target > adapted_lum, speed_up, speed_down)
    blend = 1.0 - torch.exp(-dt * speed)
    new_lum = torch.clamp(adapted_lum + (target - adapted_lum) * blend,
                          min_lum, max_lum)
    return new_lum, middle_grey / new_lum


def adapt_exposure(hdr: torch.Tensor, covered: torch.Tensor,
                   adapted_lum: torch.Tensor, dt: float, **kw):
    """Eye adaptation of a whole image: (new adapted luminance, exposure
    scale), both () tensors on the image's device; ``kw`` are
    ``adapt_from_sums``'s rates and limits.

    The reference advances donut's ToneMappingPass every frame
    (``AdvanceFrame(seconds)``, Renderer.cpp:188-189); the statistic is
    the JAX package's, the background excluded. Nothing is read back to
    the host, so the carry can thread through frames in flight. A frame
    rendered in screen bands (``parallel/sharded.py``) sums its bands'
    ``luminance_sums`` first, where the JAX package sums across devices
    (``axis_name``)."""
    return adapt_from_sums(luminance_sums(hdr, covered), adapted_lum, dt,
                           **kw)


def srgb_encode(linear: torch.Tensor) -> torch.Tensor:
    l = torch.clamp(linear, 0.0, 1.0)
    return torch.where(l <= 0.0031308, l * 12.92,
                       1.055 * torch.pow(l, 1.0 / 2.4) - 0.055)


def sky_color(view_dir_world: torch.Tensor, light_direction: torch.Tensor,
              angular_size_degrees: float = 0.53) -> torch.Tensor:
    """Procedural sky: horizon/zenith gradient + sun disc with the light's
    angular size (Renderer.cpp:136,437)."""
    d = math3d.normalize(view_dir_world)
    sun = -light_direction
    sun = sun / torch.sqrt(torch.sum(sun * sun) + 1e-20)

    elev = d[..., 1]
    zenith = _vec3([0.25, 0.45, 0.82], d)
    horizon = _vec3([0.75, 0.82, 0.92], d)
    ground = _vec3([0.28, 0.25, 0.22], d)
    t = torch.clamp(elev, 0.0, 1.0) ** 0.5
    above = horizon * (1.0 - t[..., None]) + zenith * t[..., None]
    below = torch.clamp(-elev * 8.0, 0.0, 1.0)[..., None]
    base = above * (1.0 - below) + ground * below

    cosang = torch.sum(d * sun, dim=-1)
    cos_disc = torch.cos(torch.deg2rad(sync_copy(torch.tensor(
        angular_size_degrees, dtype=torch.float32), d.device)) * 0.5)
    disc = torch.clamp(
        (cosang - cos_disc) / torch.clamp(1.0 - cos_disc, min=1e-6), 0.0, 1.0)
    glow = torch.clamp(cosang, 0.0, 1.0) ** 64 * 0.35
    sun_vis = torch.clamp(sun[1] * 10.0 + 0.5, 0.0, 1.0)
    return base + (disc * 4.0 + glow)[..., None] * sun_vis
