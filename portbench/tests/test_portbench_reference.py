"""The frozen reference against the program's own CPU path: at a small
frame on the CPU, where the program runs its kernels' plain versions,
both give the same frames bit for bit and the same counts, so the
reference is the program's semantics as it stood."""

import pytest
import torch

from portbench import cell as cellmod
from portbench import run


@pytest.mark.parametrize("workload,cameras", [
    ("horizon.flythrough-1080p", (13, 40)),
    ("map.flythrough-1080p", (13, 40)),
    ("horizon.ground-1080p", (0, 58)),
])
def test_reference_frames_equal_the_programs_cpu_frames(workload, cameras):
    c = cellmod.load(workload).scaled(120, 72, 64)
    dev = torch.device("cpu")
    hm, albedo = run.build_inputs(c, dev)
    app = run.build_app(c, 5, hm, albedo, dev)
    ref, cams = run.build_reference(c, hm, albedo, dev)
    params = run.reference_params(c, 5, dev)
    pcams = run.program_poses(c.traffic["path"], 64, hm, 2048.0)
    assert torch.equal(pcams.eye, cams.eye)
    assert torch.equal(pcams.target, cams.target)
    pre = (app.renderer.cached_horizon_prepass(app.params)
           if c.config["shadow_mode"] == "horizon" else None)
    for i in cameras:
        out, lum = app.renderer.render_adaptive(
            pcams.frame(i), app.params, torch.tensor(0.31), 1 / 60,
            shadow_prepass=pre)
        f = ref.frame(cams.frame(i), params, 0.31, 1 / 60)
        assert torch.equal(out.ldr, f.ldr) and torch.equal(out.hdr, f.hdr)
        assert torch.equal(out.prim_id, f.prim_id)
        assert torch.equal(out.depth, f.depth)
        assert torch.equal(lum, f.adapted_lum)
        k = ref.counts(cams.frame(i), params)
        assert (int(out.num_selected), int(out.num_work_items),
                int(out.overflow_mask)) == (k.selected, k.work_items,
                                            k.overflow_mask)
        assert f.counts == k
    if pre is not None:
        assert torch.equal(pre[0], ref.horizon_prepass(params)[0])


def test_work_counts_do_not_move_with_the_seed():
    c = cellmod.load("map.flythrough-1080p").scaled(120, 72, 8)
    dev = torch.device("cpu")
    hm, albedo = run.build_inputs(c, dev)
    ref, cams = run.build_reference(c, hm, albedo, dev)
    counts = [[ref.counts(cams.frame(i), run.reference_params(c, s, dev))
               for i in range(0, 8, 3)] for s in (1, 2 ** 33 + 1)]
    assert counts[0] == counts[1]
    assert all(k.light_work_items > 0 for k in counts[0])


@pytest.mark.parametrize("workload", ["horizon.flythrough-1080p",
                                      "horizon.ground-1080p"])
def test_the_app_flies_the_traffics_poses(workload):
    """The App's loop renders the poses of the cell's path, frame for
    frame; a flythrough cell's App is the program's own, untouched."""
    from vrenderer_tpu_torch import app as app_module
    from vrenderer_tpu_torch import camera as prog_camera

    c = cellmod.load(workload).scaled(120, 72, 3)
    dev = torch.device("cpu")
    hm, albedo = run.build_inputs(c, dev)
    app = run.build_app(c, 5, hm, albedo, dev)
    assert ("run_flythrough" in vars(app)) == (workload != (
        "horizon.flythrough-1080p"))
    outs = app.run_flythrough(num_frames=3, adapt=False)
    assert app_module.flythrough is prog_camera.flythrough
    poses = run.program_poses(c.traffic["path"], 3, hm, 2048.0)
    pre = app.renderer.cached_horizon_prepass(app.params)
    for i, out in enumerate(outs):
        want = app.renderer.render(poses.frame(i), app.params,
                                   shadow_prepass=pre)
        assert torch.equal(out.prim_id, want.prim_id)
        assert torch.equal(out.depth, want.depth)
        assert torch.equal(out.ldr, want.ldr)
    if workload == "horizon.ground-1080p":
        with pytest.raises(ValueError, match="the path has 3 poses"):
            app.run_flythrough(num_frames=4)
        assert app_module.flythrough is prog_camera.flythrough
        # a shorter loop flies the path's first poses
        out = app.run_flythrough(num_frames=1, adapt=False)[0]
        assert torch.equal(out.prim_id, outs[0].prim_id)
