"""A cell of ``BENCHMARK.json`` and what its files hold: the workload's
configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``), found by the names the workload gives."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict

    @property
    def frames(self) -> int:
        """Frames in one loop: the camera path's length."""
        return int(self.traffic["cameras"])

    def frame_config(self, module):
        """The cell's ``FrameConfig`` built from ``module``, the program's
        config module or the reference's copy of it."""
        c, t = self.config, self.traffic
        terrain = module.TerrainSettings(
            max_instances=int(c["max_instances"]),
            surface_size=int(c["surface_size"]),
            world_size=int(c["world_size"]), grid_size=int(c["grid_size"]))
        return module.FrameConfig(
            width=int(t["width"]), height=int(t["height"]), terrain=terrain,
            shadow_mode=c["shadow_mode"],
            shadow_resolution=int(c["shadow_resolution"]),
            shadow_select=c["shadow_select"])

    def scaled(self, width: int, height: int, cameras: int) -> "Cell":
        """The same cell at another frame size and loop length (the CPU
        dry run's)."""
        t = dict(self.traffic, width=width, height=height, cameras=cameras)
        return Cell(self.name, self.chips, self.config, t)


def _load(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load(workload: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell named ``workload`` in ``benchmark``; raises a KeyError
    naming the cells there if it has none of that name."""
    spec = _load(benchmark)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark.name}; "
                       f"cells: {', '.join(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load(ROOT / configs[w["config"]]["file"])
    traffic = _load(HERE / "traffic" / f"{w['traffic']}.json")
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic)
