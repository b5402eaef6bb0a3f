"""Camera pose, per-view constants, the scripted flythrough and the
interactive first-person and orbit controllers (``vrenderer_tpu.camera``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from vrenderer_tpu_torch.utils import math3d


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


def _look_basis(yaw: float, pitch: float):
    """(forward, forward flattened to the ground plane, right) unit
    vectors of a yaw/pitch look, float32."""
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    fwd = np.array([cp * cy, sp, cp * sy], np.float32)
    flat = np.array([cy, 0.0, sy], np.float32)
    right = np.array([-sy, 0.0, cy], np.float32)
    return fwd, flat, right


def _pose(eye: np.ndarray, target: np.ndarray, device) -> Camera:
    def t(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    return Camera(eye=t(eye), target=t(target), up=t([0.0, 1.0, 0.0]))


class FirstPersonController:
    """Interactive walk/fly camera: the reference forwards GLFW keyboard and
    mouse events to donut's FirstPersonCamera and integrates it per frame in
    Animate (Renderer.cpp:149-185). Headless, three host-side methods:

    * ``key_event(key, down)``: WASD planar move, E/Q vertical, shift
      sprints (3x);
    * ``mouse_move(dx, dy)``: yaw/pitch look, pitch clamped to +-89 deg;
    * ``animate(dt)``: the velocity approaches the commanded one
      exponentially (half-life ``accel_halflife``), then
      ``pos += vel * dt``.

    ``walk=True`` keeps the eye ``eye_height`` above the terrain (the
    heightmap sampled bilinearly on the host) and moves in the horizontal
    plane; ``walk=False`` flies along the look direction. The state is
    numpy float32; ``camera()`` snapshots it as tensors."""

    def __init__(self, camera: Optional[Camera] = None,
                 move_speed: float = 60.0, look_speed: float = 0.005,
                 accel_halflife: float = 0.15, heightmap=None,
                 world_size: float = 2048.0, max_height: float = 400.0,
                 eye_height: float = 1.8, walk: bool = False):
        cam = camera if camera is not None else Camera.default()
        self.pos = cam.eye.detach().cpu().numpy().astype(np.float32).copy()
        fwd = cam.target.detach().cpu().numpy().astype(np.float32) - self.pos
        n = float(np.linalg.norm(fwd))
        fwd = fwd / n if n > 1e-6 else np.array([0, 0, -1], np.float32)
        self.yaw = math.atan2(float(fwd[2]), float(fwd[0]))
        self.pitch = math.asin(float(np.clip(fwd[1], -1.0, 1.0)))
        self.vel = np.zeros(3, np.float32)
        self.move_speed = move_speed
        self.look_speed = look_speed
        self.accel_halflife = accel_halflife
        self.heightmap = (None if heightmap is None else
                          np.asarray(torch.as_tensor(heightmap).cpu(),
                                     np.float32))
        self.world_size = world_size
        self.max_height = max_height
        self.eye_height = eye_height
        self.walk = walk
        self._keys = set()
        if self.walk:
            self._snap_to_ground()

    def key_event(self, key: str, down: bool):
        key = key.lower()
        if down:
            self._keys.add(key)
        else:
            self._keys.discard(key)

    def mouse_move(self, dx: float, dy: float):
        self.yaw += dx * self.look_speed
        self.pitch -= dy * self.look_speed
        lim = math.radians(89.0)
        self.pitch = max(-lim, min(lim, self.pitch))

    def _ground(self, x: float, z: float) -> float:
        hm = self.heightmap
        if hm is None:
            return 0.0
        res = hm.shape[0]
        u = float(np.clip((x / self.world_size + 0.5) * (res - 1), 0.0,
                          res - 1))
        v = float(np.clip((z / self.world_size + 0.5) * (res - 1), 0.0,
                          res - 1))
        u0, v0 = int(u), int(v)
        u1, v1 = min(u0 + 1, res - 1), min(v0 + 1, res - 1)
        fu, fv = u - u0, v - v0
        h = (hm[v0, u0] * (1 - fu) * (1 - fv) + hm[v0, u1] * fu * (1 - fv)
             + hm[v1, u0] * (1 - fu) * fv + hm[v1, u1] * fu * fv)
        return float(h) * self.max_height

    def _snap_to_ground(self):
        self.pos[1] = (self._ground(float(self.pos[0]), float(self.pos[2]))
                       + self.eye_height)

    def animate(self, dt: float, device=None) -> Camera:
        fwd, flat, right = _look_basis(self.yaw, self.pitch)
        ahead = flat if self.walk else fwd
        k = self._keys
        cmd = np.zeros(3, np.float32)
        cmd += ahead * (("w" in k) - ("s" in k))
        cmd += right * (("d" in k) - ("a" in k))
        if not self.walk:
            cmd += np.array([0, 1, 0], np.float32) * (("e" in k) - ("q" in k))
        n = float(np.linalg.norm(cmd))
        speed = self.move_speed * (3.0 if "shift" in k else 1.0)
        v_cmd = cmd / n * speed if n > 1e-6 else np.zeros(3, np.float32)
        # half the remaining gap closes every accel_halflife seconds
        alpha = 1.0 - 0.5 ** (dt / max(self.accel_halflife, 1e-6))
        self.vel += (v_cmd - self.vel) * alpha
        self.pos = self.pos + self.vel * dt
        if self.walk:
            self._snap_to_ground()
        return self.camera(device)

    def camera(self, device=None) -> Camera:
        fwd, _, _ = _look_basis(self.yaw, self.pitch)
        return _pose(self.pos, self.pos + fwd, device)


class OrbitController:
    """Orbit camera around a pivot: dragging orbits (yaw/pitch, pitch
    clamped to +-89 deg), zoom scales the distance."""

    def __init__(self, pivot=(0.0, 0.0, 0.0), distance: float = 300.0,
                 yaw: float = 0.0, pitch: float = -0.5,
                 look_speed: float = 0.005):
        self.pivot = np.asarray(pivot, np.float32)
        self.distance = float(distance)
        self.yaw = float(yaw)
        self.pitch = float(pitch)
        self.look_speed = look_speed

    def drag(self, dx: float, dy: float):
        self.yaw += dx * self.look_speed
        self.pitch -= dy * self.look_speed
        lim = math.radians(89.0)
        self.pitch = max(-lim, min(lim, self.pitch))

    def zoom(self, factor: float):
        self.distance = max(1e-3, self.distance * factor)

    def camera(self, device=None) -> Camera:
        fwd, _, _ = _look_basis(self.yaw, self.pitch)
        return _pose(self.pivot + fwd * self.distance, self.pivot, device)


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
        from vrenderer_tpu_torch.ops import texture

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
