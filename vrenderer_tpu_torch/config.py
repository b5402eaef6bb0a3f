"""Configuration for the PyTorch port of the terrain renderer.

The same static dataclasses as ``vrenderer_tpu.config`` (reference:
TerrainPass.h:23-30, QuadTree.h:67), free of JAX: every field, default and
derived property is identical, so a config converts between the packages
with ``dataclasses.asdict`` (see ``convert.frame_config``). Per-frame knobs
live in ``renderer.FrameParams`` as tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TerrainSettings:
    """Static terrain configuration (TerrainPass.h:23-30: MAX_INSTANCES,
    SURFACE_SIZE, WORLD_SIZE, GRID_SIZE; QuadTree.h:67 MAX_LODS)."""

    max_instances: int = 1024
    surface_size: int = 2048
    world_size: int = 2048
    grid_size: int = 32
    max_lods: int = 12
    # selection window halfwidth in nodes per LOD level (terrain/quadtree.py)
    select_window: int = 16
    # texel addressing, "lattice" or "d3d" (ops/texture.py)
    uv_mode: str = "lattice"

    def __post_init__(self):
        if self.world_size % self.surface_size != 0:
            raise ValueError("WORLD_SIZE must be a multiple of SURFACE_SIZE")
        if self.grid_size & (self.grid_size - 1) != 0:
            raise ValueError("GRID_SIZE must be a power of two")

    @property
    def num_surfaces_per_side(self) -> int:
        return self.world_size // self.surface_size

    @property
    def num_lods(self) -> int:
        """numLods = min(MAX_LODS-1, log2(surface width)); QuadTree.cpp:22."""
        return min(self.max_lods - 1, int(math.log2(self.surface_size)))

    @property
    def verts_per_side(self) -> int:
        return self.grid_size + 1

    @property
    def tris_per_instance(self) -> int:
        return self.grid_size * self.grid_size * 2

    def lod_ranges(self, device=None) -> torch.Tensor:
        """LOD visibility ranges, range[i] = 4 * 2^i (QuadTree.cpp:234-241),
        computed on the host and moved to ``device``, so every device holds
        the host's bits."""
        i = torch.arange(self.max_lods, dtype=torch.float32)
        return (4.0 * torch.exp2(i)).to(device)


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    """Static rasterizer configuration. The fields mirror the JAX package so
    configs convert one to one. The CUDA rasterizer reads ``tile_w`` (the
    supertile size its work list bins to), ``reverse_z`` (the farthest
    covered z wins), ``wireframe`` (pixels within 1 px of an edge cover)
    and ``two_phase`` (z + id, then the attributes of the winners only,
    over the ``subtile_h`` x ``win_w`` cells the winner filter keeps;
    ignored under wireframe, as in the JAX package; the frame is
    bit-identical either way). The two-phase resolve (kernel B3b) takes at
    most ``raster_cuda.MAX_RESOLVE_INSTANCES`` = 8192 instance slots, the
    render budget plus the scene's blocks: a ``Renderer`` with more raises
    when it is built, where ``two_phase=False`` renders. The remaining
    fields shape the TPU kernel's VMEM layout and have no meaning here."""

    tile_h: int = 128
    tile_w: int = 128
    subtile_h: int = 16
    light_subtile_h: int = 8
    tri_batch: int = 32
    compact_k: int = 32
    win_w: int = 128
    two_phase: bool = False
    attr_channels: int = 8
    reverse_z: bool = False
    wireframe: bool = False


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Static whole-frame configuration: resolution + sub-configs."""

    width: int = 1920
    height: int = 1080
    terrain: TerrainSettings = dataclasses.field(default_factory=TerrainSettings)
    raster: RasterSettings = dataclasses.field(default_factory=RasterSettings)
    vfov_degrees: float = 60.0
    z_near: float = 0.1
    z_far: float = 10000.0
    shadow_resolution: int = 2048
    # "horizon" (height-field march) or "map" (depth-only light-view
    # raster, kernel B2, with comparison-filtered sampling)
    shadow_mode: str = "horizon"
    shadow_select: str = "main"
    shadow_lod_bias: int = 0
    shadow_eye_quant: float = 0.0
    shadow_cache: bool = True

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def padded_width(self) -> int:
        t = self.raster.tile_w
        return (self.width + t - 1) // t * t

    @property
    def padded_height(self) -> int:
        t = self.raster.tile_h
        return (self.height + t - 1) // t * t


@dataclasses.dataclass(frozen=True)
class LightParams:
    """Directional light; reference defaults from Renderer.cpp:135-142."""

    direction: Tuple[float, float, float] = (-0.9, -0.25, 0.35)
    irradiance: float = 1.0
    angular_size_degrees: float = 0.53
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
