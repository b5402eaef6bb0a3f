"""The port's first-person and orbit controllers against the JAX
package's under tests/test_camera_controller.py's scripted key, mouse and
time-step sequences: position, velocity, yaw, pitch and the snapshot
camera agree to 1e-5 after every step."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from vrenderer_tpu.camera import Camera as JCamera
from vrenderer_tpu.camera import FirstPersonController as JFPC
from vrenderer_tpu.camera import OrbitController as JOrbit
from vrenderer_tpu_torch import convert
from vrenderer_tpu_torch.camera import (
    Camera, FirstPersonController, OrbitController,
)

ATOL = 1e-5


def _assert_same(c, jc):
    np.testing.assert_allclose(c.pos, np.asarray(jc.pos), atol=ATOL)
    np.testing.assert_allclose(c.vel, np.asarray(jc.vel), atol=ATOL)
    assert abs(c.yaw - jc.yaw) <= ATOL and abs(c.pitch - jc.pitch) <= ATOL
    cam, jcam = c.camera(), jc.camera()
    for f in ("eye", "target", "up"):
        np.testing.assert_allclose(getattr(cam, f).numpy(),
                                   np.asarray(getattr(jcam, f)), atol=ATOL)


# (event, arguments): tests/test_camera_controller.py's sequences
RAMP = ([("key", "w", True)] + [("animate", 1.0 / 60.0)] * 120
        + [("key", "w", False)] + [("animate", 1.0 / 60.0)] * 240)
LOOK = [("mouse", 50.0, 0.0), ("mouse", 0.0, 1e6), ("animate", 0.1),
        ("mouse", -30.0, -4e5), ("animate", 0.1)]
SPRINT = ([("key", "e", True), ("animate", 1.0), ("key", "e", False),
           ("key", "w", True), ("key", "shift", True)]
          + [("animate", 0.1)] * 50
          + [("key", "a", True), ("key", "q", True), ("mouse", 7.0, -3.0)]
          + [("animate", 0.05)] * 20)
WALK = ([("key", "w", True)] + [("animate", 1.0 / 30.0)] * 30
        + [("key", "d", True), ("mouse", 40.0, 10.0)]
        + [("animate", 1.0 / 30.0)] * 30)


def _run(c, jc, events):
    for ev, *args in events:
        if ev == "key":
            c.key_event(*args)
            jc.key_event(*args)
        elif ev == "mouse":
            c.mouse_move(*args)
            jc.mouse_move(*args)
        else:
            c.animate(*args)
            jc.animate(*args)
        _assert_same(c, jc)


@pytest.mark.parametrize("name,events,kw", [
    ("ramp", RAMP, dict(move_speed=10.0, accel_halflife=0.2)),
    ("look", LOOK, dict(look_speed=0.01)),
    ("sprint", SPRINT, dict(move_speed=10.0, accel_halflife=0.01)),
], ids=["ramp", "look", "sprint"])
def test_fly_controller_matches_jax(name, events, kw):
    c, jc = FirstPersonController(**kw), JFPC(**kw)
    _assert_same(c, jc)
    _run(c, jc, events)


def test_walk_controller_matches_jax():
    """Walk mode over a real heightmap: the eye snaps to the ground."""
    from vrenderer_tpu.terrain import heightmap as jh
    from vrenderer_tpu_torch.terrain import heightmap as th

    kw = dict(world_size=64.0, max_height=20.0, eye_height=1.8, walk=True,
              move_speed=5.0)
    eye, target = [3.0, 30.0, 10.0], [-4.0, 2.0, -6.0]
    jcam = JCamera(eye=jnp.asarray(eye, jnp.float32),
                   target=jnp.asarray(target, jnp.float32),
                   up=jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    c = FirstPersonController(convert.camera(eye, target, [0.0, 1.0, 0.0]),
                              heightmap=th.procedural_heightmap(64, seed=7),
                              **kw)
    jc = JFPC(jcam, heightmap=jh.procedural_heightmap(64, seed=7), **kw)
    _assert_same(c, jc)
    _run(c, jc, WALK)
    assert float(c.pos[1]) == pytest.approx(c._ground(c.pos[0], c.pos[2])
                                            + 1.8, abs=1e-4)


def test_orbit_controller_matches_jax():
    c = OrbitController(pivot=(10.0, 0.0, 0.0), distance=100.0)
    jc = JOrbit(pivot=(10.0, 0.0, 0.0), distance=100.0)
    for op, args in (("drag", (300.0, -40.0)), ("zoom", (0.5,)),
                     ("drag", (-50.0, 1e6)), ("zoom", (1e-9,)),
                     ("zoom", (3.0,))):
        getattr(c, op)(*args)
        getattr(jc, op)(*args)
        assert c.distance == jc.distance
        assert abs(c.yaw - jc.yaw) <= ATOL and abs(c.pitch - jc.pitch) <= ATOL
        cam, jcam = c.camera(), jc.camera()
        for f in ("eye", "target", "up"):
            np.testing.assert_allclose(getattr(cam, f).numpy(),
                                       np.asarray(getattr(jcam, f)),
                                       atol=ATOL)
    assert abs(c.pitch) <= math.radians(89.0) + 1e-9


def test_default_pose_and_device():
    c = FirstPersonController()
    cam = c.camera(device="cpu")
    assert isinstance(cam, Camera) and cam.eye.device.type == "cpu"
    np.testing.assert_allclose(cam.eye.numpy(), Camera.default().eye.numpy())
