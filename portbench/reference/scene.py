"""The boot scene: one 40 m cube at (0, 120, 0) under the reference's
default sun (main.cpp:89-95, Renderer.cpp:135-142).

Frozen copy of ``vrenderer_tpu_torch.models.scene.Scene.default`` as it
stood when the benchmark was written.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from portbench.reference import math3d
from portbench.reference.config import LightParams
from portbench.reference.mesh import Mesh, cube


@dataclass
class MeshInstance:
    mesh: Mesh
    transform: torch.Tensor  # (4, 3) row-vector affine
    name: str = ""


@dataclass
class Scene:
    instances: List[MeshInstance] = field(default_factory=list)
    light: Optional[LightParams] = None

    @staticmethod
    def default(device=None) -> "Scene":
        """One 40 m cube at (0, 120, 0) and the reference's default sun
        (Renderer.cpp:135-142)."""
        return Scene(
            instances=[MeshInstance(
                mesh=cube(40.0, color=(0.8, 0.2, 0.2), device=device),
                transform=math3d.affine_translation(torch.tensor(
                    [0.0, 120.0, 0.0], dtype=torch.float32, device=device)),
                name="Cube",
            )],
            light=LightParams(),
        )
