"""The comparison can tell: the controls (the reference one precision
below the configuration's float32: its products in TF32, its shading in
bfloat16) and each fault a frame loop can have come out not correct, on
the CPU at a small size."""

import json
import math
import subprocess
import sys
from pathlib import Path
import pytest
import torch

from portbench import calibrate, check
from portbench import cell as cellmod
from portbench import run

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["horizon.flythrough-1080p", "map.flythrough-1080p",
         "horizon.ground-1080p"]


@pytest.mark.parametrize("control", calibrate.CONTROLS)
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, control):
    c = cellmod.load(workload).scaled(120, 72, 64)
    dev = torch.device("cpu")
    hm, albedo = run.build_inputs(c, dev)
    ref, cams = run.build_reference(c, hm, albedo, dev)
    params = run.reference_params(c, 9, dev)
    dt = float(c.traffic["dt"])
    ref_frames = [ref.frame(cams.frame(i), params, 0.5, dt) for i in (0, 13)]
    kept = [check.Kept(loop=0, camera=i, ldr=f.ldr, prim_id=f.prim_id,
                       depth=f.depth, lum_before=0.5,
                       lum_after=float(f.adapted_lum))
            for i, f in zip((0, 13), ref_frames)]
    sound = check.judge(check.frame_numbers(kept, ref, cams, params, dt),
                        c.config["limits"])
    assert check.passed(sound)
    ctl = calibrate.control_frames(kept, ref, cams, params, dt, control)
    numbers = check.frame_numbers(ctl, ref, cams, params, dt)
    assert not check.passed(check.judge(numbers, c.config["limits"]))
    if control == "bf16_shading":
        # finite readings, each above its limit: the image's and the
        # adaptation's limits have an upper end
        for name in ("ldr_max_err", "lum_max_rel_err"):
            assert math.isfinite(numbers[name])
            assert numbers[name] > c.config["limits"][name]


def _dry_run(args):
    out = subprocess.run([sys.executable, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["horizon.flythrough-1080p",
                                      "horizon.ground-1080p"])
@pytest.mark.parametrize("fault", ["stale_state", "half_batch",
                                   "altered_pixel", "altered_count"])
def test_each_fault_is_not_correct(fault, workload):
    line = _dry_run(["-m", "portbench.tests.faults", fault, workload, "77"])
    assert line["correct"] is False and line["failed"] >= 1
