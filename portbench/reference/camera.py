"""Camera pose, per-view constants and the camera paths of the traffic.

Frozen copy of ``vrenderer_tpu_torch.camera`` (``Camera``,
``make_view_constants``, ``flythrough``) as it stood when the benchmark
was written, and the JAX package's bench's three other paths (bench.py:
159-228), written from what they do: ``ground``, ``walk`` and ``orbit``.
``path`` picks one by the name a traffic file gives.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import math3d


class Camera(NamedTuple):
    """Pose as tensors; a flythrough stacks a leading frame axis."""

    eye: torch.Tensor        # (3,)
    target: torch.Tensor     # (3,)
    up: torch.Tensor         # (3,)

    @staticmethod
    def default(device=None) -> "Camera":
        """Reference initial pose LookAt((0,205,227.4),(1,1.8,0))
        (Renderer.cpp:97)."""
        def t(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return Camera(eye=t([0.0, 205.0, 227.4]), target=t([1.0, 1.8, 0.0]),
                      up=t([0.0, 1.0, 0.0]))

    def world_to_view(self) -> torch.Tensor:
        return math3d.look_at(self.eye, self.target, self.up)

    def frame(self, i: int) -> "Camera":
        """Camera ``i`` of a stacked flythrough."""
        return Camera(eye=self.eye[i], target=self.target[i], up=self.up[i])


def make_view_constants(camera: Camera, width: int, height: int,
                        vfov_degrees: float = 60.0, z_near: float = 0.1,
                        z_far: float = 10000.0):
    """PlanarViewConstants equivalent (donut's FillPlanarViewConstants,
    TerrainPass.cpp:281); keys match the JAX package.

    The matrices are computed on the host, as the reference fills them on
    the CPU, and moved to the camera's device. The card's cross products,
    sums and matrix products round differently in the last bits, and LOD
    selection at a ground-height eye follows those bits (frustum planes
    through the eye cut boxes at its height)."""
    dev = camera.eye.device
    host = Camera(*(f.detach().to("cpu") for f in camera))
    w2v = host.world_to_view()
    proj = math3d.persp_proj_d3d_style(
        math.radians(float(vfov_degrees)), width / height, z_near, z_far)
    vp = math3d.view_proj(w2v, proj)
    out = {
        "world_to_view": w2v,
        "view_to_clip": proj,
        "world_to_clip": vp,
        "clip_to_world": math3d.inverse_4x4(vp),
        "view_to_world": math3d.inverse_affine(w2v),
        "viewport": torch.tensor([width, height], dtype=torch.float32),
    }
    out = {k: v.to(dev) for k, v in out.items()}
    out["camera_pos"] = camera.eye
    return out


def flythrough(num_frames: int, world_size: float = 2048.0,
               altitude: float = 205.0, radius_frac: float = 0.3,
               heightmap: torch.Tensor | None = None,
               max_height: float = 400.0, clearance: float = 60.0,
               device=None) -> Camera:
    """The deterministic orbit + descent flythrough of the 1080p benchmark
    (camera.py:259-302 of the JAX package). With a heightmap the path keeps
    ``clearance`` above the terrain. Fields carry a leading (num_frames,)
    axis; ``Camera.frame(i)`` picks one. The path is computed on the host
    and moved to ``device`` (the heightmap's): the card's cos and sin round
    otherwise, and the views follow the poses' last bits."""
    if heightmap is not None:
        device = heightmap.device
        heightmap = heightmap.cpu()
    t = math3d.linspace(0.0, 1.0, num_frames)
    ang = t * 2.0 * math.pi
    r = world_size * radius_frac * (1.0 - 0.5 * t)
    alt = altitude * (1.0 - 0.6 * t) + 40.0
    ex = r * torch.cos(ang)
    ez = r * torch.sin(ang)
    if heightmap is not None:
        from portbench.reference import texture

        ground = texture.sample_points(
            heightmap,
            (ex + world_size * 0.5) / world_size,
            (ez + world_size * 0.5) / world_size,
        ) * max_height
        alt = torch.maximum(alt, ground + clearance)
    eye = torch.stack([ex, alt, ez], dim=-1)
    look_ang = ang + 0.9
    target = torch.stack(
        [(r * 0.3) * torch.cos(look_ang), torch.full_like(t, 5.0),
         (r * 0.3) * torch.sin(look_ang)],
        dim=-1,
    )
    up = torch.tensor([0.0, 1.0, 0.0],
                      dtype=torch.float32).expand(eye.shape).contiguous()
    return Camera(eye=eye.to(device), target=target.to(device),
                  up=up.to(device))


# the ring and the orbit come round once in this many frames; a pose does
# not depend on the length of the loop that flies it
PERIOD = 64


def _terrain_eyes(heightmap: torch.Tensor, world_size: float,
                  max_height: float, points) -> np.ndarray:
    """Eyes (x, height, z) float32 for ``(x, z, above)`` in float64: the
    terrain's height at the texel that truncation of (x, z)'s texel
    coordinates names, times ``max_height``, plus ``above``."""
    hm = heightmap.detach().cpu().numpy()
    last = hm.shape[0] - 1
    rows = []
    for x, z, above in points:
        col = int(np.clip((x / world_size + 0.5) * last, 0, last))
        row = int(np.clip((z / world_size + 0.5) * last, 0, last))
        rows.append((x, float(hm[row, col]) * max_height + above, z))
    return np.asarray(rows, np.float32)


def _stacked(eye, target, device) -> Camera:
    eye = torch.as_tensor(eye, dtype=torch.float32)
    up = torch.tensor([0.0, 1.0, 0.0]).expand(eye.shape).contiguous()
    return Camera(eye=eye.to(device),
                  target=torch.as_tensor(target, dtype=torch.float32
                                         ).to(device),
                  up=up.to(device))


def ground(num_frames: int, heightmap: torch.Tensor, world_size: float,
           max_height: float = 400.0) -> Camera:
    """A ring of radius 160 m round the origin, the eye 2.5 m above the
    terrain, looking 50 m ahead along the ground at 0.6 rad past its own
    bearing (bench.py's ``ground`` mode)."""
    ang = [2.0 * np.pi * i / PERIOD for i in range(num_frames)]
    eye = _terrain_eyes(heightmap, world_size, max_height,
                        [(160.0 * np.cos(a), 160.0 * np.sin(a), 2.5)
                         for a in ang])
    ahead = np.asarray([(np.cos(a + 0.6), np.sin(a + 0.6)) for a in ang],
                       np.float32) * np.float32(50.0)
    target = eye + np.stack([ahead[:, 0], np.zeros(num_frames, np.float32),
                             ahead[:, 1]], axis=-1)
    return _stacked(eye, target, heightmap.device)


def walk(num_frames: int, heightmap: torch.Tensor, world_size: float,
         max_height: float = 400.0) -> Camera:
    """A straight walk from (-60, 40), 2 m along x and 0.35 m along z a
    frame, the eye 2 m above the terrain, looking at the fixed offset
    (40, -2, 25) (bench.py's ``mapwalk`` mode)."""
    eye = _terrain_eyes(heightmap, world_size, max_height,
                        [(-60.0 + 2.0 * i, 40.0 + 0.35 * i, 2.0)
                         for i in range(num_frames)])
    target = eye + np.asarray([[40.0, -2.0, 25.0]], np.float32)
    return _stacked(eye, target, heightmap.device)


def orbit(num_frames: int, device=None) -> Camera:
    """The eye fixed 800 m above the origin, where the four surfaces of a
    4096 m world meet, the gaze turning round a circle of 60 m on the
    ground plane (bench.py's ``envelope`` mode). The angles are float32
    and taken on the host: the card's cos and sin round otherwise."""
    ang = torch.from_numpy(np.float32(2.0 * np.pi)
                           * np.arange(num_frames, dtype=np.float32)
                           / np.float32(PERIOD))
    eye = torch.tensor([[0.0, 800.0, 0.0]]).repeat(num_frames, 1)
    target = torch.stack([60.0 * torch.cos(ang), torch.zeros_like(ang),
                          60.0 * torch.sin(ang)], dim=-1)
    return _stacked(eye, target, device)


PATHS = ("flythrough", "ground", "walk", "orbit")


def path(name: str, num_frames: int, heightmap: torch.Tensor,
         world_size: float, max_height: float = 400.0) -> Camera:
    """The ``num_frames`` poses of the camera path ``name``, on the
    heightmap's device."""
    if name == "flythrough":
        return flythrough(num_frames, world_size=world_size,
                          heightmap=heightmap, max_height=max_height)
    if name == "ground":
        return ground(num_frames, heightmap, world_size, max_height)
    if name == "walk":
        return walk(num_frames, heightmap, world_size, max_height)
    if name == "orbit":
        return orbit(num_frames, heightmap.device)
    raise ValueError(f"unknown camera path {name!r}; one of "
                     f"{', '.join(PATHS)}")
