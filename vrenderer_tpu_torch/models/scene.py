"""Scene: mesh instances + a directional light (Renderer.cpp:101-147).

``Scene.default()`` is the boot scene (the Cube.gltf analog, main.cpp:89-95)
of ``vrenderer_tpu.models.scene``. The glTF/PNG loader is not ported yet
(ROADMAP.md, A14); ``convert.scene`` builds a Scene from arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from vrenderer_tpu_torch.config import LightParams
from vrenderer_tpu_torch.models.mesh import Mesh, cube
from vrenderer_tpu_torch.utils import math3d


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
