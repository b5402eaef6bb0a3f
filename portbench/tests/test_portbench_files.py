"""BENCHMARK.json and the files it names: each loads, is well formed and
imports nothing of JAX or the JAX package."""

import ast
import json
import re
from pathlib import Path
import pytest
import torch

from portbench import bounds, cell, traffic
from portbench.reference import camera
from portbench.reference import config as ref_config
from portbench.reference import precision

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "vrenderer_tpu"}


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")


def test_run_seconds_fit_the_check_at_24_cells():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_load(workload):
    c = cell.load(workload)
    assert c.chips == 1
    assert c.frames == 64 and c.traffic["path"] in camera.PATHS
    assert c.frames <= camera.PERIOD or c.traffic["path"] == "flythrough"
    assert c.traffic["height"] % 128 == 0
    for key in ("light_irradiance", "light_color", "exposure",
                "ambient_intensity"):
        lo, hi = c.traffic["seeded"][key]
        assert 0 < lo < hi
    cfg = c.frame_config(ref_config)
    assert cfg.width == c.traffic["width"]
    assert cfg.shadow_mode == c.config["shadow_mode"]


@pytest.mark.parametrize("spec", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files_state_their_limits(spec):
    conf = json.loads((ROOT / spec["file"]).read_text())
    assert conf["name"] == spec["name"] and conf["source"] == spec["source"]
    assert {"ldr_max_err", "lum_max_rel_err"} <= set(conf["limits"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    mod = __import__(f"portbench.metrics.{metric}", fromlist=["read"])
    assert callable(mod.read)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.parts:
        assert "vrenderer_tpu_torch" not in tops


def test_seed_varies_shading_only():
    t = cell.load("horizon.flythrough-1080p").traffic
    a = traffic.frame_params(t, 1)
    b = traffic.frame_params(t, 2 ** 31 + 12345)
    assert a != b and set(a) == set(t["seeded"])
    assert traffic.frame_params(t, 1) == a
    cams = traffic.checked_cameras(t, 2 ** 31 + 7, heaviest=13)
    assert 13 in cams and len(cams) == 3 and cams == sorted(set(cams))
    assert cams == traffic.checked_cameras(t, 2 ** 31 + 7, heaviest=13)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.14159, 0.0,
                      float("inf")])
    y = precision.round_tf32(x)
    assert y.tolist()[:2] == [1.0 + 2 ** -10, 1.0]
    assert y[2] == -3.140625 and y[3] == 0.0 and y[4] == float("inf")
    with precision.tf32():
        a = torch.tensor([[1.0 + 2 ** -12]])
        assert precision.matmul(a, a).item() == 1.0


def test_raster_bytes_count_rows_once_and_each_pixel():
    from portbench.reference.renderer import Counts

    c = Counts(selected=300, work_items=900, work_instances=200,
               light_work_items=1300, light_work_instances=560,
               overflow_mask=0)
    main = 200 * 2048 * 64 + 1920 * 1152 * 40
    assert bounds.raster_bytes(c, 2048, 1920, 1152, 2048, False) == main
    assert bounds.raster_bytes(c, 2048, 1920, 1152, 2048, True) == (
        main + 560 * 2048 * 64 + 2048 * 2048 * 4)


def test_bf16_shading_store_rounds_to_bfloat16():
    x = torch.tensor([1.0 + 2 ** -9, 1.0 + 2 ** -7, 0.3])
    assert torch.equal(precision.store(x), x)
    with precision.bf16_shading():
        y = precision.store(x)
    assert y.dtype == torch.float32
    assert y.tolist()[:2] == [1.0, 1.0 + 2 ** -7]
    assert torch.equal(y, x.to(torch.bfloat16).float())


def _trace(spans, window_s=1.0, frames=2):
    import numpy as np
    from portbench import trace

    return trace.Trace(window_s=window_s, frames=frames,
                       names=[n for n, _, _ in spans],
                       start_ns=np.array([s for _, s, _ in spans]),
                       end_ns=np.array([e for _, _, e in spans]))


def test_trace_busy_and_idle_by_the_activity_that_ends_a_gap():
    from portbench import trace

    t = _trace([("a", 0, 100), ("b", 50, 150), ("c", 400, 500),
                ("a", 900, 1000)])
    assert t.busy_s == pytest.approx(350e-9)
    assert t.idle_by_next() == pytest.approx({"c": 250e-9, "a": 400e-9})
    b = trace.breakdown(t)
    assert [k for k, _ in b["idle_gaps"]] == ["until a", "until c"]
    assert b["device_ops"][0] == ["a", pytest.approx(200e-9)]


def test_device_idle_share_reads_the_untraced_loops_wall_time():
    from portbench import run
    from portbench.metrics import device_idle_share

    t = _trace([("k", 0, 250_000_000)], window_s=1.5)
    loops = [run.Loop(frames=2, frame_ms=[1.0, 1.0])] * 2
    r = run.Run(cell=None, loops=loops, window_s=2.0, trace=t)
    # 0.25 s busy in a loop that takes 1.0 s untraced, not 1.5 s traced
    assert device_idle_share.read(r) == 75.0
    assert device_idle_share.read(run.Run(cell=None, loops=[])) is None


def _path_cell(path):
    c = cell.load("horizon.flythrough-1080p")
    return cell.Cell(c.name, c.chips, c.config, dict(c.traffic, path=path))


def _poses(path):
    """The reference's and the program's poses of a whole loop of
    ``path``, on the benchmark's terrain."""
    from portbench import run

    c = _path_cell(path)
    hm, _ = run.build_inputs(c, torch.device("cpu"))
    ref = camera.path(path, c.frames, hm, 2048.0, max_height=400.0)
    return ref, run.program_poses(path, c.frames, hm, 2048.0)


@pytest.mark.parametrize("path", [*camera.PATHS, "spiral"])
def test_unknown_camera_path_is_refused(path):
    """Each path's poses are the program's bit for bit; another path is
    refused on both sides, naming the paths there are."""
    from portbench import run

    if path not in camera.PATHS:
        for build in (lambda c: run.build_app(c, 1, None, None,
                                              torch.device("cpu")),
                      lambda c: run.build_reference(c, None, None,
                                                    torch.device("cpu"))):
            with pytest.raises(ValueError, match="camera path .*"
                               "flythrough, ground, walk, orbit"):
                build(_path_cell(path))
        return
    ref, prog = _poses(path)
    assert ref.eye.shape == (64, 3)
    for a, b in zip(ref, prog):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)
    # a pose does not depend on the length of the loop
    if path != "flythrough":
        hm, _ = run.build_inputs(_path_cell(path), torch.device("cpu"))
        short = camera.path(path, 4, hm, 2048.0)
        assert all(torch.equal(a[:4], b) for a, b in zip(ref, short))


@pytest.mark.parametrize("path", camera.PATHS)
def test_reference_look_at_equals_the_programs(path):
    from vrenderer_tpu_torch.utils import math3d as prog_math3d

    from portbench.reference import math3d

    ref, _ = _poses(path)
    for i in range(ref.eye.shape[0]):
        cam = ref.frame(i)
        assert torch.equal(math3d.look_at(*cam),
                           prog_math3d.look_at(*cam))
