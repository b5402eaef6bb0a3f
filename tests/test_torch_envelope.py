"""The benchmark's ``envelope`` configuration through the program on the
CPU: the original's full instance capacity (4096 slots of selection) over
a 4096 m world of four 2048 m quadtrees, 1024 slots through the vertex
stage, setup and binning, at a small frame. The App's renderer, built as
``portbench/run.py`` builds it, equals the frozen plain reference
(``portbench/reference``) bit for bit at two orbit cameras, and so does
the horizon prepass over the 4096 m world; the orbit's selection passes
the one-surface cells' 512 instances, covers all four surfaces and fits
the render budget; the App's loop counts its slots."""

import pytest
import torch

import torch_parity  # noqa: F401  (one PyTorch thread a test process)
from portbench import cell as cellmod
from portbench import run

CAMERAS = (0, 40)
DEV = torch.device("cpu")


@pytest.fixture(scope="module")
def envelope():
    """(cell, App, reference, reference cameras, reference params) at
    120x72."""
    c = cellmod.load("envelope.orbit-4k").scaled(120, 72, 64)
    hm, albedo = run.build_inputs(c, DEV)
    app = run.build_app(c, 7, hm, albedo, DEV)
    ref, cams = run.build_reference(c, hm, albedo, DEV)
    return c, app, ref, cams, run.reference_params(c, 7, DEV)


def test_the_cell_is_the_published_capacity_over_four_surfaces(envelope):
    c, app, ref, _, _ = envelope
    for cfg in (app.config, app.renderer.config, ref.config):
        ts = cfg.terrain
        assert (ts.world_size, ts.surface_size, ts.max_instances,
                ts.grid_size) == (4096, 2048, 4096, 32)
        assert ts.num_surfaces_per_side == 2
    assert app.renderer.max_active == ref.max_active == 1024
    assert app.renderer.max_work == 6144


def test_app_frames_equal_the_reference(envelope):
    c, app, ref, cams, params = envelope
    pcams = run.program_poses("orbit", 64, app.heightmap, 4096.0)
    assert torch.equal(pcams.eye, cams.eye)
    assert torch.equal(pcams.target, cams.target)
    pre = app.renderer.cached_horizon_prepass(app.params)
    assert torch.equal(pre[0], ref.horizon_prepass(params)[0])
    for i in CAMERAS:
        out, lum = app.renderer.render_adaptive(
            pcams.frame(i), app.params, torch.tensor(0.31), 1 / 60,
            shadow_prepass=pre)
        f = ref.frame(cams.frame(i), params, 0.31, 1 / 60)
        assert torch.equal(out.ldr, f.ldr) and torch.equal(out.hdr, f.hdr)
        assert torch.equal(out.prim_id, f.prim_id)
        assert torch.equal(out.depth, f.depth)
        assert torch.equal(lum, f.adapted_lum)
        assert (int(out.num_selected), int(out.num_work_items),
                int(out.overflow_mask)) == (f.counts.selected,
                                            f.counts.work_items,
                                            f.counts.overflow_mask)
        assert f.counts.overflow_mask == 0
        # bench.py's orbit: 606-632 instances a frame at 3840x2176
        assert 606 <= f.counts.selected <= 632


@pytest.mark.parametrize("camera", CAMERAS)
def test_selection_spans_four_surfaces_within_the_budget(envelope, camera):
    _, app, _, _, _ = envelope
    r = app.renderer
    pcams = run.program_poses("orbit", 64, app.heightmap, 4096.0)
    sel = r.select(pcams.frame(camera))
    count = int(sel.count)
    assert 512 < count <= r.max_active < sel.valid.shape[0]
    assert int(sel.valid.sum()) == count
    pos = sel.position[sel.valid]
    quadrants = {(bool(x > 0), bool(z > 0)) for x, z in
                 zip(pos[:, 0].tolist(), pos[:, 2].tolist())}
    assert len(quadrants) == 4


def test_app_loop_counts_its_slots(envelope):
    """One frame of the App's loop with spans on: the main view's
    ``Select`` hands the vertex stage 1024 slots of the 4096 selected,
    and the frame's counters carry its selection and work list."""
    _, app, _, _, _ = envelope
    app.profiler.spans = True
    try:
        out = app.run_flythrough(num_frames=1)[0]
    finally:
        app.profiler.spans = False
    ring = app.profiler.frames
    selects = {e["id"] for f in ring for e in f["events"]
               if e["name"] == "Select"}
    got = {(c["name"], c["value"]) for f in ring for c in f["counters"]
           if c["name"] != "Slots" or c["span"] in selects}
    assert got == {("Slots", 1024), ("Instances", int(out.num_selected)),
                   ("Work items", int(out.num_work_items))}
