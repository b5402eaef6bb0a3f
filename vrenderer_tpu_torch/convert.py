"""Build the port's objects from the JAX package's state given as plain
numpy arrays and dicts, so the same state can drive both packages. This
module never imports JAX: the caller converts (``np.asarray``,
``dataclasses.asdict``, ``NamedTuple._asdict``).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from vrenderer_tpu_torch.camera import Camera
from vrenderer_tpu_torch.config import (
    FrameConfig, LightParams, RasterSettings, TerrainSettings,
)
from vrenderer_tpu_torch.models.mesh import Mesh
from vrenderer_tpu_torch.models.scene import MeshInstance, Scene
from vrenderer_tpu_torch.renderer import FrameParams
from vrenderer_tpu_torch.terrain.quadtree import SelectedInstances


def tensor(a, device=None) -> torch.Tensor:
    """numpy array (or array-like) -> tensor with the same dtype."""
    return torch.as_tensor(np.array(a), device=device)


def frame_config(d: Mapping[str, Any]) -> FrameConfig:
    """FrameConfig from ``dataclasses.asdict`` of the JAX FrameConfig."""
    d = dict(d)
    d["terrain"] = TerrainSettings(**d["terrain"])
    d["raster"] = RasterSettings(**d["raster"])
    return FrameConfig(**d)


def light_params(d: Mapping[str, Any]) -> LightParams:
    """LightParams from ``dataclasses.asdict`` of the JAX LightParams."""
    return LightParams(direction=tuple(d["direction"]),
                       irradiance=float(d["irradiance"]),
                       angular_size_degrees=float(d["angular_size_degrees"]),
                       color=tuple(d["color"]))


def frame_params(d: Mapping[str, Any], device=None) -> FrameParams:
    """FrameParams from the JAX FrameParams' ``_asdict()`` (numpy values)."""
    return FrameParams(**{k: tensor(np.asarray(d[k], np.float32), device)
                          for k in FrameParams._fields})


def camera(eye, target, up, device=None) -> Camera:
    """Camera from eye/target/up arrays ((3,) or stacked (N, 3))."""
    return Camera(eye=tensor(np.asarray(eye, np.float32), device),
                  target=tensor(np.asarray(target, np.float32), device),
                  up=tensor(np.asarray(up, np.float32), device))


def selected_instances(position, extents, lod, valid, count,
                       device=None) -> SelectedInstances:
    """SelectedInstances from the JAX selection's arrays."""
    return SelectedInstances(
        position=tensor(np.asarray(position, np.float32), device),
        extents=tensor(np.asarray(extents, np.float32), device),
        lod=tensor(np.asarray(lod, np.int32), device),
        valid=tensor(np.asarray(valid, bool), device),
        count=tensor(np.asarray(count, np.int32), device),
    )


def shadow_prepass(depth, wtc, z_range, overflow, shear, device=None):
    """The map-mode prepass tuple (``Renderer.shadow_prepass``) from the
    JAX package's: depth (R, R), world->clip (4, 4), z range, overflow flag
    and the shear (kx, kz, span_x, span_z)."""
    return (tensor(np.asarray(depth, np.float32), device),
            tensor(np.asarray(wtc, np.float32), device), float(z_range),
            tensor(np.asarray(overflow, np.int32), device),
            tuple(tensor(np.asarray(v, np.float32), device) for v in shear))


def scene(instances: Sequence[Mapping[str, Any]],
          light: Optional[Mapping[str, Any]] = None, device=None) -> Scene:
    """Scene from per-instance dicts with ``positions``, ``normals``,
    ``colors`` (V, 3), ``tris`` (T, 3), ``transform`` (4, 3) and an
    optional ``name``."""
    out = []
    for d in instances:
        mesh = Mesh(
            positions=tensor(np.asarray(d["positions"], np.float32), device),
            normals=tensor(np.asarray(d["normals"], np.float32), device),
            colors=tensor(np.asarray(d["colors"], np.float32), device),
            tris=tensor(np.asarray(d["tris"], np.int64), device),
        )
        out.append(MeshInstance(
            mesh=mesh,
            transform=tensor(np.asarray(d["transform"], np.float32), device),
            name=d.get("name", "")))
    return Scene(instances=out,
                 light=None if light is None else light_params(light))
