"""The traffic generator: what a run's ``--seed`` varies, read from the
traffic file's data.

A loop is one call of the App's loop over ``cameras`` poses of the file's
camera ``path`` (``flythrough``, ``ground``, ``walk`` or ``orbit``:
``reference/camera.py``) at the file's frame size; the window is made of
whole loops, so every run renders every camera equally often. The seed
never changes a loop's work: the terrain, the cameras, the sun's
direction and the budgets are fixed by the cell. It draws what leaves the
work alone:

* the light's irradiance and colour, the exposure and the ambient
  intensity, each uniform in the file's ``seeded`` range; they change
  every shaded pixel and the eye adaptation's course, not the selection,
  the work lists or the rasters;
* which frames the check compares with the reference: frame 0 of the
  window's first loop (the start of eye adaptation), the loop's heaviest
  camera and ``checked_frames`` more cameras of the window's last loop.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one use; seeds past 32 bits are fine."""
    return np.random.default_rng([int(seed) & ((1 << 63) - 1), stream])


def frame_params(traffic: dict, seed: int) -> Dict[str, object]:
    """The seeded shading inputs: floats, and ``light_color`` a list of 3."""
    g = rng(seed, 1)
    s = traffic["seeded"]
    out = {}
    for key in ("light_irradiance", "exposure", "ambient_intensity"):
        lo, hi = s[key]
        out[key] = float(g.uniform(lo, hi))
    lo, hi = s["light_color"]
    out["light_color"] = [float(v) for v in g.uniform(lo, hi, 3)]
    return out


def checked_cameras(traffic: dict, seed: int, heaviest: int) -> List[int]:
    """The cameras of the window's last loop whose frames the check
    compares: the heaviest and ``checked_frames`` others drawn from the
    seed, in order."""
    n = int(traffic["cameras"])
    others = [i for i in range(n) if i != heaviest]
    k = min(int(traffic["checked_frames"]), len(others))
    drawn = rng(seed, 2).choice(len(others), size=k, replace=False)
    return sorted({heaviest, *(others[int(i)] for i in drawn)})
