"""The comparison that decides ``correct``: what the window's App loops
produced, held to the plain reference (``portbench/reference``), which
recomputes everything from the benchmark's own inputs.

* Every frame of every loop: the selection's raw count, the work items
  and the overflow mask equal the reference's for that camera
  (``count_mismatch``, exact), and no frame overflows a budget
  (``overflow_frames``, exact: an overflowing frame may miss geometry).
* The checked frames (``traffic.checked_cameras``): each primitive id and
  depth equal the reference's (``id_mismatch_px``, ``depth_max_err``,
  exact), the sRGB frame lies within ``ldr_max_err`` of it, and the eye
  adaptation's step within ``lum_max_rel_err``. The reference follows the
  adaptation from the program's carry before the frame (it would have to
  render every earlier frame otherwise); frame 0 of the first loop starts
  from the initial 0.5, so the start is checked on its own.
* Horizon cells: the shadow field the loops used equals the reference's
  (``shadow_max_err``, exact). A map cell's light-view depth is no output
  of the loop; it reaches the frame through the shadow factors, so the
  frame's numbers hold it.

A number that is not finite reads ``inf``. The limits are the
configuration's (``limits`` in its file), each set from the program's
readings over many seeds and the control's (PERF.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

EXACT = ("count_mismatch", "overflow_frames", "id_mismatch_px",
         "depth_max_err", "shadow_max_err")


@dataclass
class Kept:
    """A checked frame of the program, as the loop produced it."""

    loop: int
    camera: int
    ldr: torch.Tensor
    prim_id: torch.Tensor
    depth: torch.Tensor
    lum_before: float
    lum_after: float


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    if not bool(torch.isfinite(d).all()):
        return math.inf
    return float(d.max()) if d.numel() else 0.0


def count_numbers(prog_counts: List[List[tuple]], ref_counts) -> Dict:
    """``prog_counts``: per loop, per camera (selected, work items,
    overflow mask)."""
    mismatch = overflow = 0
    for loop in prog_counts:
        for cam, (sel, work, mask) in enumerate(loop):
            r = ref_counts[cam]
            mismatch += (sel, work, mask) != (r.selected, r.work_items,
                                              r.overflow_mask)
            overflow += mask != 0
    return {"count_mismatch": float(mismatch),
            "overflow_frames": float(overflow)}


def frame_numbers(kept: List[Kept], reference, cameras, params,
                  dt: float) -> Dict:
    """The checked frames against the reference's frames of the same
    cameras from the same adaptation carry."""
    ids = 0
    depth = ldr = lum = 0.0
    for k in kept:
        f = reference.frame(cameras.frame(k.camera), params, k.lum_before,
                            dt)
        ids += int((k.prim_id != f.prim_id).sum())
        depth = max(depth, _max_abs(k.depth, f.depth))
        ldr = max(ldr, _max_abs(k.ldr, f.ldr))
        want = float(f.adapted_lum)
        err = abs(k.lum_after - want) / abs(want) if want else math.inf
        lum = max(lum, err if math.isfinite(err) else math.inf)
        del f
    return {"id_mismatch_px": float(ids), "depth_max_err": depth,
            "ldr_max_err": ldr, "lum_max_rel_err": lum}


def shadow_numbers(prog_field: Optional[torch.Tensor], reference, params
                   ) -> Dict:
    if prog_field is None:
        return {}
    field, _ = reference.horizon_prepass(params)
    return {"shadow_max_err": _max_abs(prog_field, field)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}}; a number without a limit in the
    configuration fails (limit None)."""
    out = {}
    for name, value in numbers.items():
        limit = 0.0 if name in EXACT else limits.get(name)
        out[name] = {"value": value, "limit": limit}
    return out


def passed(checks: Dict) -> bool:
    return all(c["limit"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
