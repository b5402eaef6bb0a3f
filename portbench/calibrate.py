"""The readings that the limits of ``check.py`` were set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 1,2,3]

On the card, in one process: the cell's set-up and warm loop once, then
for each seed one whole loop of the App with that seed's shading, its
checked frames held to the reference (the program's readings, the lower
ends of the limits), and for each control seed the controls: the
reference one precision below the configuration's float32
(``reference/precision.py``: its products in TF32, and its shading in
bfloat16), put in the program's place at the same cameras and carries
(the upper ends). One JSON line a seed and a summary line of the largest
program reading and each control's smallest reading of each number. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from portbench import run as runmod  # noqa: E402


def _ints(text: str):
    return [int(v) for v in text.split(",") if v]


CONTROLS = ("tf32", "bf16_shading")


def control_frames(kept, reference, cameras, params, dt: float,
                   control: str = "tf32"):
    """A control in the program's place: the reference's frames at the
    checked cameras, from the same carries, in the precision of
    ``control`` (a context of ``reference/precision.py``)."""
    from portbench import check
    from portbench.reference import precision

    out = []
    with getattr(precision, control)():
        for k in kept:
            f = reference.frame(cameras.frame(k.camera), params,
                                k.lum_before, dt)
            out.append(check.Kept(
                loop=k.loop, camera=k.camera, ldr=f.ldr, prim_id=f.prim_id,
                depth=f.depth, lum_before=k.lum_before,
                lum_after=float(f.adapted_lum)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from portbench import cell as cellmod
    from portbench import check, traffic

    cell = cellmod.load(args.workload)
    if args.dry_run:
        cell = cell.scaled(**runmod.DRY_RUN)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = cell.frames
    dt = float(cell.traffic["dt"])
    fly = dict(num_frames=n, dt=dt,
               frames_in_flight=int(cell.traffic["frames_in_flight"]))
    hm, albedo = runmod.build_inputs(cell, device)
    app = runmod.build_app(cell, args.seeds[0], hm, albedo, device)
    warm = runmod.frame_counts(app.run_flythrough(**fly))
    heaviest = max(range(n), key=lambda i: warm[i][1])
    ref, cams = runmod.build_reference(cell, hm, albedo, device)
    ref_counts = None
    worst, least = {}, {c: {} for c in CONTROLS}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        app.params = runmod.program_params(cell, seed, device)
        params = runmod.reference_params(cell, seed, device)
        if ref_counts is None:
            ref_counts = [ref.counts(cams.frame(i), params)
                          for i in range(n)]
        outs = app.run_flythrough(**fly)
        counts = runmod.frame_counts(outs)
        checked = traffic.checked_cameras(cell.traffic, seed, heaviest)
        kept = [runmod.kept_frame(app, outs, 0, c)
                for c in sorted({0, *checked})]
        del outs
        line = {"seed": seed, "cameras": [k.camera for k in kept]}
        if seed in args.seeds:
            nums = check.count_numbers([counts], ref_counts)
            nums.update(check.frame_numbers(kept, ref, cams, params, dt))
            if cell.config["shadow_mode"] == "horizon":
                nums.update(check.shadow_numbers(
                    app.renderer.cached_horizon_prepass(app.params)[0], ref,
                    params))
            line["program"] = nums
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v)
        if seed in args.control_seeds:
            for name in CONTROLS:
                ctl = control_frames(kept, ref, cams, params, dt, name)
                nums = check.frame_numbers(ctl, ref, cams, params, dt)
                line[f"control_{name}"] = nums
                for k, v in nums.items():
                    least[name][k] = min(least[name].get(k, math.inf), v)
                del ctl
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": cell.name, "program_max": worst,
                      "control_min": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
