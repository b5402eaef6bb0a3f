"""Shared inputs for the parity tests of vrenderer_tpu_torch against
vrenderer_tpu: the small configuration of tests/test_golden.py and
tests/test_raster_pallas.py (256x128 frame, 64-unit world, grid 8,
max_instances 64), built once per package from the same numpy state.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from vrenderer_tpu.camera import Camera as JCamera
from vrenderer_tpu.config import FrameConfig as JFrameConfig
from vrenderer_tpu.config import TerrainSettings as JTerrainSettings
from vrenderer_tpu_torch import convert

# A parallel test run (pytest-xdist) starts one process per worker, and
# each imports this module while it collects the tests. PyTorch gives every
# process an intra-op pool of one thread per core, whose threads spin
# between parallel regions: a few such pools oversubscribe the cores and
# slow every worker. The tests' tensors are small, so each process keeps
# PyTorch to one thread.
torch.set_num_threads(1)

W, H = 256, 128
JSET = JTerrainSettings(surface_size=64, world_size=64, max_instances=64,
                        grid_size=8)
JCFG = JFrameConfig(width=W, height=H, terrain=JSET)
CFG = convert.frame_config(dataclasses.asdict(JCFG))
SET = CFG.terrain


def np32(x):
    return np.asarray(x, np.float32)


def t(x):
    """numpy/JAX array -> CPU tensor of the same dtype."""
    return convert.tensor(np.asarray(x))


def cameras(eye, target):
    """The same pose for both packages."""
    up = [0.0, 1.0, 0.0]
    jcam = JCamera(eye=jnp.asarray(eye, jnp.float32),
                   target=jnp.asarray(target, jnp.float32),
                   up=jnp.asarray(up, jnp.float32))
    return jcam, convert.camera(eye, target, up)


def frame_params_pair(max_height=12.0):
    from vrenderer_tpu.renderer import FrameParams as JFrameParams

    jp = JFrameParams.default()._replace(max_height=jnp.float32(max_height))
    return jp, convert.frame_params({k: np.asarray(v)
                                     for k, v in jp._asdict().items()})


def assert_close(a, b, atol=0.0, rtol=0.0, err_msg=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=err_msg)
