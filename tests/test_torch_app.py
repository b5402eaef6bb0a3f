"""The App shell of vrenderer_tpu_torch against vrenderer_tpu's on the CPU:
the adapting flythrough, pipelining, PNGs, the window title, the per-pass
counters and the frame profiler.

The App's scripted flythrough flies at 205 m, so in the 64 m world of
tests/torch_parity.py the terrain covers about 700 pixels of sub-pixel
triangles whose depth planes are ill-conditioned: there the jitted JAX
frame differs from its own op-by-op frame at 20 of 697 covered pixels (the
port equals the op-by-op frame at every pixel), which moves the geometric
mean luminance by 2e-4. The flythrough tests therefore use the same frame,
grid and budget in a 512 m world, where the jitted JAX frame is
well-conditioned and tests/test_torch_frame.py's bounds hold.
"""

import dataclasses
import json
import os
import struct
import time
import zlib

import numpy as np
import pytest
import torch

from vrenderer_tpu.config import FrameConfig as JFrameConfig
from vrenderer_tpu.config import TerrainSettings as JTerrainSettings
from vrenderer_tpu_torch import convert
from vrenderer_tpu_torch.app import App, write_png
from vrenderer_tpu_torch.profiler import (
    REFERENCE_CPU_COUNTERS, REFERENCE_GPU_COUNTERS, FrameProfiler,
)
from vrenderer_tpu_torch.terrain.heightmap import load_png

JCFG = JFrameConfig(width=256, height=128, terrain=JTerrainSettings(
    surface_size=512, world_size=512, max_instances=64, grid_size=8))
CFG = convert.frame_config(dataclasses.asdict(JCFG))
FRAMES = 3


def port_app(cfg=CFG, **kw):
    return App(cfg, heightmap_resolution=64, device="cpu", **kw)


@pytest.fixture(scope="module")
def flythrough_pair(tmp_path_factory):
    """Both Apps after the same 3-frame adapting flythrough."""
    from vrenderer_tpu.app import App as JApp

    out = tmp_path_factory.mktemp("frames")
    japp = JApp(JCFG, heightmap_resolution=64, raster_backend="xla")
    with pytest.warns(UserWarning, match="render budget"):
        jouts = japp.run_flythrough(num_frames=FRAMES)
    app = port_app()
    with pytest.warns(UserWarning, match="render budget"):
        outs = app.run_flythrough(num_frames=FRAMES, dump_dir=str(out),
                                  trace_path=str(out / "trace.json"))
    return japp, jouts, app, outs, out


def test_flythrough_matches_jax(flythrough_pair):
    """adapt_history to rtol 1e-5, frames to tests/test_torch_frame.py's
    bounds (the XLA rasterizer counts no work items)."""
    japp, jouts, app, outs, _ = flythrough_pair
    assert len(outs) == FRAMES and len(app.adapt_history) == FRAMES
    np.testing.assert_allclose(app.adapt_history, japp.adapt_history,
                               rtol=1e-5)
    assert abs(app.adapt_history[-1] - 0.5) > 1e-3
    assert torch.equal(app.adapted_lum,
                       torch.tensor(app.adapt_history[-1]))
    for o, jo in zip(outs, jouts):
        same = o.prim_id.numpy() == np.asarray(jo.prim_id)
        assert same.mean() >= 0.999
        d = np.abs(o.ldr.numpy() - np.asarray(jo.ldr))
        assert d.mean() < 5e-4
        assert d[same].max() < 5e-3
        assert int(o.num_instances) == int(jo.num_instances)
        assert int(o.num_selected) == int(jo.num_selected)
        assert int(o.overflow_mask) == int(jo.overflow_mask) == 2


def test_flythrough_dumps_and_traces(flythrough_pair):
    _, _, app, outs, out = flythrough_pair
    for i, o in enumerate(outs):
        img = load_png(str(out / f"frame_{i:04d}.png")).numpy()
        want = (np.clip(o.ldr.numpy(), 0.0, 1.0) * 255.0 + 0.5).astype(
            np.uint8).astype(np.float32) / np.float32(255.0)
        np.testing.assert_array_equal(img, want)
    with open(out / "trace.json") as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"]}
    assert {"Render", "Wait GPU", "Present", "CPU Frame"} <= names
    assert app.profiler.average_frame_ms() > 0
    evs = [e for f in app.profiler.frames for e in f["events"]]
    assert {"Render", "Wait GPU", "Present"} <= {e["name"] for e in evs}
    assert max(e["frame"] for e in evs) >= FRAMES
    assert all(e["end"] > e["start"] for e in evs)


def test_flythrough_pipelining_order_and_adapt_opt_out(tmp_path):
    """Frames retire in order with up to 2 in flight; without adaptation
    each frame equals ``render`` of its camera, no history is kept, and
    one frame in flight gives the same frames."""
    from vrenderer_tpu_torch.camera import flythrough

    app = port_app()
    with pytest.warns(UserWarning):
        outs = app.run_flythrough(num_frames=FRAMES, dump_dir=str(tmp_path),
                                  adapt=False, frames_in_flight=2)
    assert app.adapt_history == []
    names = [e["name"] for f in app.profiler.frames for e in f["events"]]
    assert names.count("Wait GPU") == FRAMES
    cams = flythrough(FRAMES, world_size=CFG.terrain.world_size,
                      heightmap=app.heightmap, max_height=400.0)
    for i, o in enumerate(outs):
        assert os.path.exists(tmp_path / f"frame_{i:04d}.png")
        ref = app.renderer.render(cams.frame(i), app.params)
        assert torch.equal(o.ldr, ref.ldr) and torch.equal(o.prim_id,
                                                            ref.prim_id)
    with pytest.warns(UserWarning):
        serial = app.run_flythrough(num_frames=FRAMES, adapt=False,
                                    frames_in_flight=1)
    assert all(torch.equal(a.ldr, b.ldr) for a, b in zip(outs, serial))
    with pytest.raises(ValueError, match="frames_in_flight"):
        app.run_flythrough(num_frames=1, frames_in_flight=0)


def _png(path, img, filters):
    """An 8-bit PNG of ``img`` (H, W) or (H, W, C) whose row y uses PNG
    filter ``filters[y % len(filters)]`` (0-4)."""
    arr = img if img.ndim == 3 else img[..., None]
    h, w, c = arr.shape
    rows = arr.reshape(h, w * c).astype(np.int64)
    raw = []
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            pa, pb, pc = (np.abs(up - ul), np.abs(left - ul),
                          np.abs(left + up - 2 * ul))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        raw.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                              0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(raw)))
                 + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4],
                         ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_load_png_matches_pillow(tmp_path, channels):
    """The zlib reader against the JAX package's pillow reader, every
    filter type on every channel layout, and write_png's output read back
    exactly."""
    from vrenderer_tpu.terrain import heightmap as jh

    rng = np.random.default_rng(channels)
    shape = (19, 23) if channels == 1 else (19, 23, channels)
    noise = rng.integers(0, 256, shape).astype(np.uint8)
    smooth = np.cumsum(noise.astype(np.int64), axis=1).astype(np.uint8)
    for name, img, filters in (("noise", noise, (0, 1, 2, 3, 4)),
                               ("smooth", smooth, (4, 3, 2, 1, 0))):
        path = str(tmp_path / f"{name}.png")
        _png(path, img, filters)
        got = load_png(path).numpy()
        np.testing.assert_array_equal(got, np.asarray(jh.load_png(path)))
        np.testing.assert_array_equal(got, img.astype(np.float32) / 255.0)
    if channels == 3:
        f = rng.random((16, 32, 3)).astype(np.float32)
        path = str(tmp_path / "w.png")
        write_png(path, f)
        want = np.floor(f * 255.0 + 0.5).astype(np.float32) / 255.0
        np.testing.assert_array_equal(load_png(path).numpy(), want)


def test_load_png_rejects_other_pngs(tmp_path):
    path = tmp_path / "bad.png"
    _png(str(path), np.zeros((4, 4), np.uint8), (0,))
    blob = bytearray(path.read_bytes())
    blob[24] = 16                           # bit depth 16
    blob[29:33] = struct.pack(">I", zlib.crc32(bytes(blob[12:29])))
    path.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="bit depth 16"):
        load_png(str(path))
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        load_png(str(path))


def test_window_title_matches_jax():
    from vrenderer_tpu.profiler import FrameProfiler as JFrameProfiler

    frames = [{"start": 0.0, "events": [
        {"name": "CPU Frame", "start": 0.0, "end": 0.0125, "depth": -1}]}]
    app = port_app()
    app.profiler.frames = [dict(f) for f in frames]
    jprof = JFrameProfiler()
    jprof.frames = frames
    assert app.window_title() == "vrenderer_tpu 12.5 ms/frame (80 FPS)"
    assert app.profiler.average_frame_ms() == jprof.average_frame_ms()


@pytest.mark.parametrize("mode", ["horizon", "map"])
def test_profile_passes_counters(mode):
    """Every counter the JAX App measures, with the boot cube."""
    from vrenderer_tpu_torch.models.scene import Scene

    cfg = CFG if mode == "horizon" else dataclasses.replace(
        CFG, shadow_mode="map", shadow_resolution=128)
    app = port_app(cfg, scene=Scene.default())
    timer = app.profile_passes(long=2)
    want = ["TerrainPass::UpdateTransforms", "Scene Refresh", "GBuffer fill",
            "Terrain", "Deferred Lighting", "ToneMapping", "Sky",
            "GPU Frame"]
    want += (["ShadowMap", "Cascade ShadowMap"] if mode == "map"
             else ["Terrain Shadow"])
    assert sorted(timer.results) == sorted(want)
    assert set(want) <= set(REFERENCE_GPU_COUNTERS) | set(
        REFERENCE_CPU_COUNTERS)
    assert all(v > 0 for v in timer.results.values())
    assert "GPU Frame" in timer.table()


def _scripted(prof):
    """One scripted event sequence: two frames, nested scopes."""
    prof.begin_frame()
    with prof.scope("Render"):
        with prof.scope("Terrain"):
            pass
        with prof.scope("Sky"):
            pass
    with prof.scope("Wait GPU"):
        pass
    prof.end_frame()
    prof.begin_frame()
    with prof.scope("Present"):
        pass
    prof.end_frame()


def test_chrome_trace_matches_jax(tmp_path):
    from vrenderer_tpu.profiler import FrameProfiler as JFrameProfiler

    traces = []
    for prof in (FrameProfiler(), JFrameProfiler()):
        _scripted(prof)
        path = tmp_path / f"{len(traces)}.json"
        prof.export_chrome_trace(str(path))
        with open(path) as fh:
            traces.append([(e["name"], e["tid"], e["pid"], e["ph"])
                           for e in json.load(fh)["traceEvents"]])
    assert traces[0] == traces[1]
    assert ("Terrain", 1, 0, "X") in traces[0]


def test_frame_profiler_pause_threshold_and_rings():
    p = FrameProfiler(pause_threshold_ms=1.0, history=3, time_history=5)
    p.begin_frame()
    time.sleep(0.003)                 # over the threshold: auto-pause
    p.end_frame()
    assert p.paused
    n_frames = len(p.frames)
    p.begin_frame()
    with p.scope("Render"):
        pass
    p.end_frame()
    assert len(p.frames) == n_frames      # the ring is frozen while paused
    p.paused = False
    for _ in range(8):
        p.begin_frame()
        with p.scope("Render"):
            with p.scope("Terrain"):
                pass
        p.end_frame()
    assert len(p.frames) == 3 and len(p.frame_times_ms) == 5
    depths = {e["name"]: e["depth"] for e in p.frames[-1]["events"]}
    assert depths == {"Render": 0, "Terrain": 1, "CPU Frame": -1}
    # frames are counted through the pause: the ring's last three are the
    # 8th to 10th begun, each with its Render
    evs = [e for f in p.frames for e in f["events"]]
    assert [e["frame"] for e in evs if e["name"] == "Render"] == [8, 9, 10]
    assert p.frame == 10


def test_flamegraph_svg(tmp_path):
    p = FrameProfiler()
    path = tmp_path / "empty.svg"
    p.export_flamegraph_svg(str(path))
    assert path.read_text().startswith("<svg")
    _scripted(p)
    path = tmp_path / "flame.svg"
    p.export_flamegraph_svg(str(path))
    svg = path.read_text()
    assert svg.startswith("<svg") and svg.endswith("</svg>")
    for name in ("Render", "Terrain", "Sky", "Wait GPU", "Present",
                 "CPU Frame"):
        assert f"<title>{name}: " in svg


def test_device_trace_on_cpu(tmp_path):
    from vrenderer_tpu_torch.profiler import (
        start_device_trace, stop_device_trace,
    )

    start_device_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        start_device_trace(str(tmp_path))
    torch.ones(64).sum()
    prof = stop_device_trace()
    assert prof.key_averages() is not None
    with open(tmp_path / "trace.json") as fh:
        assert json.load(fh)["traceEvents"]
    with pytest.raises(RuntimeError, match="no device trace"):
        stop_device_trace()


def test_app_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        App(CFG, heightmap_resolution=64)
