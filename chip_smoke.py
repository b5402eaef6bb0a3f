#!/usr/bin/env python3
"""Drive the PyTorch port (``vrenderer_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line and raising on failure:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 is switched off for matmuls and cuDNN, since the JAX
   package runs its matrix products in full float32 (Precision.HIGHEST);
2. build: nvcc compiles ``vrenderer_tpu_torch/csrc`` (seconds printed,
   ptxas' registers and spills), and the shared-memory atomics each region
   kernel compiled to (cuobjdump's SASS: native ``ATOMS.MIN`` or a
   compare-and-swap loop);
3. kernel vs plain: the CUDA rasterizer B1 against its plain PyTorch
   version on the card at the 1080p horizon path's inputs (flythrough
   cameras 0 and 13, 13 being the heavy grazing view): ids and z equal,
   attrs within 1e-5, both timed with CUDA events, beside the bound (the
   least time the card could take for the input's bytes and operations),
   the (triangle, pixel) pairs covered, evaluated by the kernel's block
   test (``raster_cuda.block_pair_rects``, its PyTorch mirror) and in the
   triangles' bboxes, and the kernel's time in each layout of LAYOUTS
   (region side, blocks a cluster; equal output checked too); then B1 under
   reverse-z and in wireframe, and kernel B3a under reverse-z, against
   their plain versions at the same inputs;
4. two-phase kernels: B3a (z + id) against its plain version and B1's z
   and id, the winner filter kernel's work list and live (item, cell)
   pairs against its plain version, B3b (the winners' attrs) against its
   plain version and B1's attrs, the whole two-phase raster against B1, all
   bitwise; CUDA-event times of B3a, the filter kernel and its plain
   version, B3b, the whole two-phase raster and B1;
5. golden frame: the 256x128 frame of tests/test_golden.py rendered
   through the kernel, held to the stored frames;
6. horizon path: the 1080p horizon-shadow flythrough with the boot cube
   and the cached horizon prepass, all 64 cameras, every frame finite,
   covered in (0, 1) and without overflow; CUDA-event frame times;
7. two-phase path (this slice's): the same flythrough with
   ``RasterSettings(two_phase=True)``, each frame's ldr, depth, prim_id and
   overflow mask bit-identical to phase 6's frame, 65 launches each of
   B3a, the filter and B3b and none of B1; then a few frames each with
   reverse-z and in wireframe, finite, covered in (0, 1), without overflow;
8. depth kernel vs plain: kernel B2 against its plain version and against
   kernel B1's z at the map cell's light-pass inputs (2048x2048, cameras 0
   and 13): z bitwise equal to both, both timed with CUDA events, with the
   pair counts and layouts of phase 3; then
   kernel B1 against its plain version at the map path's main-raster
   inputs (768 + 1 instance slots in the light selection's order, the
   membership mask leaving shared slots invalid), as in phase 3;
9. map golden frame: the 256x128 map-mode frame of
   tests/test_torch_map_frame.py, held to the op-by-op JAX frame and light
   passes (camera eye and default eye) stored in
   tests/golden_map_frame_unfused.npz;
10. map path: the 1080p map-shadow flythrough (bench.py --mode map: light
    pass from the main eye at 2048x2048, geometry shared with the main
    pass), all 64 cameras and a warm-up frame, every frame finite, covered
    in (0, 1) and without overflow (bits 1, 2 and 4); CUDA-event frame
    times;
11. cached map variant (bench.py --mode mapcache: light-eye selection and
    the cached prepass): 8 cameras bit-identical to inline frames, one
    light raster for the cached loop, ``render_shadow_depth`` equal to the
    cached map;
12. app path (run after phase 6): the port's own entry point,
    ``App.run_flythrough`` at 1920x1152 with the boot cube (what
    ``python -m vrenderer_tpu_torch.capture`` runs). Run 1, 4 frames with
    PNG dumps and a chrome trace: each PNG read back through ``load_png``
    equals the frame quantized to 8 bits, the trace holds the Render, Wait
    GPU, Present and CPU Frame scopes, the native event ring is filled.
    Run 2, 64 adapting frames: the luminance history finite, away from
    0.5, and equal to a hand-threaded ``render_adaptive`` chain; 64 B1
    launches. Run 3, 64 frames without adaptation, each bit-identical to
    ``Renderer.render``. The App's frame times and "Wait GPU" share; a
    ``passes`` JSON line of ``App.profile_passes`` at camera 13 in horizon
    mode and in map mode (phase 10's configuration); a ``torch.profiler``
    device trace of 2 frames (device kernels and busy ms per frame, the
    busy share of the frames' CUDA-event time, the top kernels); then an
    App on the native 1024x1024 heightmap. Every App frame finite, covered
    in (0, 1) and without overflow. Each part prints its seconds;
13. editor path: the port's second entry point, the ``Editor`` around an
    App at 1920x1152 (max_instances 1024, max_work 2048). A GLB written
    here with numpy (``write_scene_glb``: a 256x256 RGB PNG whose rows use
    all five filters, a textured quad that ``load_gltf`` subdivides to
    131072 triangles, 64 scene blocks, a vertex-coloured box under rotation
    and non-uniform scale, a matrix node) is loaded by the ``load``
    command; then EDITOR_SCRIPT: render, walk and step, orbit, drag and
    zoom, light, debug-quadtree, terrain off/on, lock, move-instance,
    reload, stats, fps, trace, flamegraph, shadow-depth, fly 8,
    clear-scene, with renders between. No response may be an error; every
    frame finite, covered in (0, 1), overflow mask 0 (work items printed
    against max_work); B1's launches are the frames plus the mesh-top
    fields (one a frame with a scene, one for the flythrough's cache), B2's
    the shadow-depth; the frame after reload is bit-identical to the one
    before; the lock frame equals ``render_locked`` with ``select``'s
    instances. Then B1 against its plain version at two editor cameras and
    on the mesh-top field's compact triangles (one instance), B2 at the
    shadow-depth light pass, with times, pairs and bounds; the "xla" and
    "pallas" backends at 256x128 with the loaded scene (ids equal, depth
    1e-6, attrs 3e-4); the editor's CUDA-event frame times;
14. sharded path: ``parallel.sharded.render_frames_sharded`` at 1920x1152
    (the horizon renderer of phase 6 without its prepass cache, as the
    JAX package's sharded path runs): (a) the card's own (1, 1) mesh, 8
    cameras, frames and overflow bit-identical to ``Renderer.render``;
    (b) three bands on one card, ``["cuda:0"] * 6`` as (frame 2, tile 3),
    6 cameras with eye adaptation, each frame within tests/test_sharded.py's
    bound of a ``render_adaptive`` chain per 3-frame chunk (under 1e-4 of
    the pixels off by more than 2e-3), the adapted luminance equal across
    bands and within 1e-5 of the chain; (c) map mode at (1, 3), 2 cameras,
    the same bound against single frames, B2 once a band; (d)
    ``two_phase`` at (1, 3), frames bit-identical to the single-phase
    banded frames; launches counted per run (B1 runs twice a band in
    horizon mode: the mesh-top field and the main raster); (e) B1, B3a,
    the filter and B3b at band 1 of 3 and B2 at the map path's light pass
    against their plain versions, timed as in phases 3, 4 and 8; a
    ``sharded`` JSON line with the CUDA-event frame times;
15. workload modes: the JAX bench's modes through
    ``vrenderer_tpu_torch.workloads`` at full size (WORKLOAD_VARIANTS: 4k,
    envelope, ground, mapref, mapsnap at quant 256 and 64, mapwalk, map at
    a 1024^2 light map). For each: ``probe`` (no overflow at camera 0; the
    envelope selects more than 512 instances), then ``steady_frames`` over
    all 64 cameras with the cache its loop keeps; every frame finite,
    coverage in (0, 1) (up to 1 for the ground-height eyes of ground and
    mapwalk), and at every camera the selection count, the work items
    and the overflow mask equal to the JAX package's op-by-op counts in
    tests/workload_counts_jax.npz (overflow only where the JAX package
    overflows); before the variants, ``vertex_stage_bits``: at envelope
    camera 40 the vertex stage's world and attrs, the poses and the work
    items bit for bit equal on the card and on the CPU, with each of the
    stage's operations and what it used before (torch's float32 sqrt, its
    sum, the einsum sampler) compared alone (ROADMAP C); the
    launches (B1 a frame, plus the horizon prepass's
    mesh-top field; B2 a frame in mapref and map, once in mapsnap and
    mapwalk per cell crossing plus the fill); the cached frames (the first,
    the last and, for the quantized eye, the first after a crossing)
    bit-identical to inline ``Renderer.render`` frames; ``camera_stats``
    (CUDA-event frame times, spread, slowest cameras, correlations). Then
    B1 against its plain version at the camera of 4k, envelope and ground
    whose input the block test evaluates most pairs of, B2 at the heaviest
    light pass of mapwalk and of the 1024^2 map, with times, pairs and
    bounds; the 4k per-pass table; a ``workloads`` JSON line and the
    phase's seconds;
16. probes: the microbenchmarks of ``vrenderer_tpu_torch.probes`` (what
    ``python -m vrenderer_tpu_torch.probes`` runs), the counterparts of the
    JAX package's Mosaic probes under scripts/, at their full sizes. P1
    ``vrt_probe_sweep``: 512 dependent sweeps over 512 x 1024 float32 as
    FMA, multiply then add, min and compare-select, and probe_fma's ev()
    chain (32 x 2048, 512 reps) in four modes; P2 ``vrt_probe_eval``: 1024
    work items' 16 mask rows ranked and compacted from row-major and
    component-major triangle rows, and 32 rows evaluated against
    probe_exact's random and edge right-hand sides (4096 px); P3
    ``vrt_probe_merge``: the per-pixel minimum with the lowest index merged
    by 64-bit and 32-bit shared atomics and by owner threads, at the
    probe's (2048 x 128) and a hot spot's (4096 x 4096) pairs, one region a
    streaming multiprocessor; P4 ``vrt_probe_window``: probe_window's
    16-column group sums and the coefficient gather of B1's output pass at
    the horizon frame's camera 13, by scalar and by float4 loads. Every case
    bit for bit equal to its plain version; times, rates and bounds with the
    card's name; SASS instruction counts of P1 (FFMA against FMUL and FADD)
    and P3 (the shared atomics); a ``probes`` JSON line.

Each path's kernel launches are counted from 0 just before it runs. Then
one JSON line with each kernel's launches (on its path: B1 and B2 on the
map path, B3a and B3b on the two-phase path; B1 and B2 also carry the
editor path's launches and numbers under ``editor_launches`` and
``editor``, and the workload modes' launches and their kernel checks under
``workloads_launches`` and ``workloads``, and each kernel the sharded
path's launches and its band numbers under ``sharded_launches`` and
``sharded``; P1-P4 the probes' launches, their reported case under
``case`` and every case under ``cases``), and its error, times and
bound at camera 13, with each camera's under ``cameras`` (B1's at the
map path's inputs, B3a's and B3b's at the horizon path's), and for B1, B2
and B3a the pairs their block test evaluates (``evaluated_pairs``) beside
the covered and bbox pairs, for B1 and B2 the time of each layout
(``layout_ms``), and beside B3b the filter kernel's launches, time, plain
time and bound (``filter_*``); the bound's operations count the
(triangle, pixel) pairs the triangles cover; then
the nvidia-smi line, and as the last line ``{"ok": true, "device":
{...}}``. Without a CUDA device it raises and prints no result. Kernel
times queue their launches behind a device sleep, so they are the
device's and not the host's launch rate (``cuda_ms``).
"""

from __future__ import annotations

import json
import re
import struct
import subprocess
import sys
import time
import zlib
from collections import Counter
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# CUDA-event timing (kernel reps queued behind a device sleep) and the
# bound against the H100's data-sheet peaks
from vrenderer_tpu_torch.probes.common import bound, cuda_ms  # noqa: E402

WIDTH, HEIGHT = 1920, 1152          # bench.py's 1080p frame (9 supertiles)
MAX_ACTIVE, MAX_WORK = 512, 2048    # bench.py's horizon-mode budgets
MAP_MAX_ACTIVE = 768                # bench.py's map-mode render budget
SHADOW_RES = 2048                   # bench.py's light-map resolution
KERNEL_CAMERAS = (0, 13)
# (region side, blocks a cluster) of the region kernels timed in phases 3
# and 8
LAYOUTS = ((64, 1), (64, 2), (64, 4), (64, 8), (64, 16), (128, 1),
           (128, 4))
JSON_CAMERA = 13                    # the heavy grazing view
CACHED_CAMERAS = 8
APP_FRAMES = 64                     # the App's adapting and fixed runs
APP_DUMP_FRAMES = 4                 # the App's run with PNGs and a trace
APP_DT = 1.0 / 60.0                 # run_flythrough's adaptation step
TRACE_CAMERAS = (0, 13)             # the frames of the device trace
MODE_CAMERAS = (0, 13, 32)          # frames of the reverse-z and wire modes
# phase 13: the editor's commands ("{glb}" and "{tmp}" filled in). The
# first camera looks down at the scene floating above the central peak;
# the orbit camera circles it. Eye adaptation steps by wall time, so it
# goes off before the frames that are compared with each other. The walk
# ends 1.8 m above the terrain looking at the horizon, where the terrain
# alone can pass max_work (its near nodes span many supertiles): that
# view is not rendered, its work items are printed.
EDITOR_VIEW = "camera 0 520 420  0 300 0"
EDITOR_SCRIPT = [
    EDITOR_VIEW, "load {glb}", "render",
    "walk on", "step 0.05 w 5 -60", "step 0.05 W 0 -60", "step 0.05 wd -3 2",
    EDITOR_VIEW, "orbit on", "drag 250 60", "zoom 0.7", "render",
    "light 120 35", "render",
    "debug-quadtree on", "render", "debug-quadtree off",
    "terrain off", "render", "terrain on",
    "adapt off", "lock", "drag 40 0", "render", "unlock",
    "move-instance 0 30 0 0", "render", "reload", "render",
    "stats", "fps", "trace {tmp}/trace.json", "flamegraph {tmp}/flame.svg",
    "shadow-depth {tmp}/shadow.png", "fly 8", "clear-scene",
    "render",
]
EDITOR_KERNEL_FRAMES = (0, 1)       # renders whose cameras B1 is held at
BACKEND_SIZE = (256, 128)           # the xla-vs-pallas comparison's frame
ATTR_TOL = 1e-5   # kernel and plain round every plane op the same way
# phase 14: the sharded screen-band path. 1152 rows split into 1, 3 or 9
# bands of whole 128-row supertiles; one card runs a band on each entry
# of a mesh that repeats it
SHARD_CAMERAS = tuple(range(0, 64, 8))         # (a), the (1, 1) mesh
SHARD_ADAPT_CAMERAS = (0, 11, 22, 33, 44, 55)  # (b), (frame 2, tile 3)
SHARD_FEW_CAMERAS = (0, 13)                    # (c) and (d), (1, 3)
SHARD_BANDS = 3
SHARD_DT = 0.1                                 # the JAX tests' step
# tests/test_sharded.py:46-52: rebased planes (c + b*y0) may flip exact
# silhouette pixels, so under 1e-4 of a frame's pixels may differ by more
# than 2e-3 in a channel; the bands' luminance sums add in another order
SHARD_PIXEL_TOL, SHARD_PIXEL_SHARE = 2e-3, 1e-4
SHARD_LUM_RTOL = 1e-5
# phase 15: the JAX bench's workload modes (vrenderer_tpu_torch/workloads.py)
# as (name, mode, quant, shadow_res), named as in tests/workload_counts_jax.npz
WORKLOAD_VARIANTS = (
    ("4k", "4k", None, None), ("envelope", "envelope", None, None),
    ("ground", "ground", None, None), ("mapref", "mapref", None, None),
    ("mapsnap", "mapsnap", None, None),
    ("mapsnap-q64", "mapsnap", 64.0, None),
    ("mapwalk", "mapwalk", None, None), ("map-r1024", "map", None, 1024),
)
WORKLOAD_B1 = ("4k", "envelope", "ground")      # B1 at the heaviest camera
WORKLOAD_B2 = ("mapwalk", "map-r1024")          # B2 at the heaviest light pass
# phase 15: the view at which the card's vertex stage once rounded otherwise
# and binned 3079 work items against the CPU's 3075 (ROADMAP C)
VERTEX_MODE, VERTEX_CAMERA = "envelope", 40
# ground-height eyes may see no sky: a frame may be covered whole
WORKLOAD_FULL_COVER = ("ground", "mapwalk")
VIS_BYTES = 64        # one triangle's 16 visibility floats
COEF_BYTES = 108      # one triangle's 27 attribute plane coefficients
PAIR_OPS = 16         # 3 edge + 1 depth plane per (triangle, pixel) pair
RESOLVE_OPS = 44      # 9 planes and 8 divisions per covered pixel


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit PNG of ``img`` (H, W) gray or (H, W, C) uint8, C = 2
    (gray+alpha), 3 or 4, whose row y uses filter y % 5: None, Sub, Up,
    Average and Paeth in turn."""
    arr = img if img.ndim == 3 else img[..., None]
    h, w, c = arr.shape
    rows = arr.reshape(h, w * c).astype(np.int64)
    raw = b""
    for y in range(h):
        kind = y % 5
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 4:
            pa, pb, pc = (np.abs(up - ul), np.abs(left - ul),
                          np.abs(left + up - 2 * ul))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        else:
            pred = (0 * cur, left, up, (left + up) // 2)[kind]
        raw += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def scene_texture(size: int, seed: int) -> np.ndarray:
    """A (size, size, 3) uint8 texture from ``seed``: smooth colour waves
    with a little noise, so that every PNG filter has work."""
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    ph = rng.uniform(0.0, 2.0 * np.pi, 3)
    waves = [0.5 + 0.4 * np.sin(2 * np.pi * (i * (k + 1) + j * (3 - k))
                                / size + ph[k]) for k in range(3)]
    tex = np.stack(waves, -1) + rng.normal(0.0, 0.02, (size, size, 3))
    return np.clip(tex * 255.0 + 0.5, 0, 255).astype(np.uint8)


def write_scene_glb(path, tex_size: int = 256, quad_size: float = 120.0,
                    center=(0.0, 340.0, 0.0), root_yaw: float = 20.0,
                    seed: int = 7) -> None:
    """The editor path's scene as a GLB, written with numpy: a root node at
    ``center`` (rotated ``root_yaw`` degrees about y) with two children,
    * "quad": a +y-facing square of ``quad_size`` metres (non-uniform
      scale 1 x 0.75) textured by ``scene_texture(tex_size)`` (a PNG in the
      binary chunk, rows in all five filters), its uvs spanning 0.7 of the
      texture: ``load_gltf`` subdivides it to 131072 triangles at 256
      texels (64 blocks of 2048);
    * "pillar": a box with per-vertex COLOR_0 and a base colour factor,
      under rotation and non-uniform scale, floating above the quad (no
      face coplanar with it), with a grandchild "cap" (the same box)
      placed by a column-major matrix."""
    s = 0.5
    quad_pos = np.asarray([(-s, 0, s), (s, 0, s), (s, 0, -s), (-s, 0, -s)],
                          np.float32)
    quad_nrm = np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1))
    quad_uv = (0.15 + 0.7 * np.asarray([(0, 0), (1, 0), (1, 1), (0, 1)])
               ).astype(np.float32)
    quad_idx = np.asarray([0, 1, 2, 0, 2, 3], np.uint32)
    faces = [((0, 0, 1), [(-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]),
             ((0, 0, -1), [(s, -s, -s), (-s, -s, -s), (-s, s, -s),
                           (s, s, -s)]),
             ((1, 0, 0), [(s, -s, s), (s, -s, -s), (s, s, -s), (s, s, s)]),
             ((-1, 0, 0), [(-s, -s, -s), (-s, -s, s), (-s, s, s),
                           (-s, s, -s)]),
             ((0, 1, 0), [(-s, s, s), (s, s, s), (s, s, -s), (-s, s, -s)]),
             ((0, -1, 0), [(-s, -s, -s), (s, -s, -s), (s, -s, s),
                           (-s, -s, s)])]
    box_pos = np.asarray([c for _, cs in faces for c in cs], np.float32)
    box_nrm = np.asarray([n for n, cs in faces for _ in cs], np.float32)
    box_col = (0.25 + 0.5 * (box_pos + s)).astype(np.float32)
    box_idx = np.asarray([[4 * f, 4 * f + 1, 4 * f + 2, 4 * f, 4 * f + 2,
                           4 * f + 3] for f in range(6)], np.uint16).ravel()
    png = png_bytes(scene_texture(tex_size, seed))

    blob, views, accessors = b"", [], []

    def add(data: bytes):
        nonlocal blob
        blob += b"\0" * (-len(blob) % 4)
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(data)})
        blob += data
        return len(views) - 1

    def accessor(arr, kind, ctype):
        accessors.append({"bufferView": add(arr.tobytes()),
                          "componentType": ctype,
                          "count": int(arr.shape[0]), "type": kind})
        return len(accessors) - 1

    f32, u16, u32 = 5126, 5123, 5125
    quad = {"attributes": {"POSITION": accessor(quad_pos, "VEC3", f32),
                           "NORMAL": accessor(quad_nrm, "VEC3", f32),
                           "TEXCOORD_0": accessor(quad_uv, "VEC2", f32)},
            "indices": accessor(quad_idx, "SCALAR", u32), "material": 0}
    box = {"attributes": {"POSITION": accessor(box_pos, "VEC3", f32),
                          "NORMAL": accessor(box_nrm, "VEC3", f32),
                          "COLOR_0": accessor(box_col, "VEC3", f32)},
           "indices": accessor(box_idx, "SCALAR", u16), "material": 1}
    image_view = add(png)
    ang = np.radians(root_yaw)
    cap = np.eye(4)
    cap[:3, :3] *= 0.6
    cap[:3, 3] = (0.0, 0.8, 0.0)
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {"name": "root", "translation": list(map(float, center)),
             "rotation": [0.0, float(np.sin(ang / 2)), 0.0,
                          float(np.cos(ang / 2))], "children": [1, 2]},
            {"name": "quad", "mesh": 0,
             "scale": [quad_size, 1.0, 0.75 * quad_size]},
            {"name": "pillar", "mesh": 1, "children": [3],
             "translation": [0.3 * quad_size, 0.15 * quad_size, 0.0],
             "rotation": [0.0, 0.0, float(np.sin(0.2)), float(np.cos(0.2))],
             "scale": [quad_size / 15, quad_size / 5, quad_size / 24]},
            {"name": "cap", "mesh": 1,
             "matrix": [float(v) for v in cap.T.ravel()]},
        ],
        "meshes": [{"primitives": [quad]}, {"primitives": [box]}],
        "materials": [
            {"pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "baseColorFactor": [0.9, 0.95, 1.0, 1.0]}},
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.3, 0.2, 1.0]}}],
        "textures": [{"source": 0}],
        "images": [{"bufferView": image_view, "mimeType": "image/png"}],
        "accessors": accessors, "bufferViews": views,
        "buffers": [{"byteLength": len(blob)}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<III", 0x46546C67, 2,
                             12 + 8 + len(js) + 8 + len(blob)))
        fh.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        fh.write(struct.pack("<II", len(blob), 0x004E4942) + blob)


def raster_work(vis, work, width: int, height: int, tile: int):
    """This input's data-dependent raster work: (bytes of the work list and
    of the visibility rows of its instances, {covered_pairs: (triangle,
    pixel) pairs the triangles cover, evaluated_pairs: pairs the kernels'
    block test leaves to the exact test, bbox_pairs: pairs in the
    triangles' bboxes}). A covered pair needs its 3 edge planes and its
    depth plane; the pairs that the kernel evaluates and rejects are its
    design's cost, not the function's, so the bound counts covered pairs
    only."""
    import torch

    from vrenderer_tpu_torch.ops import raster_cuda

    n_inst = int(torch.unique(work.items[work.items[:, 0] >= 0, 0]).numel())
    pairs = {
        "covered_pairs": sum(int(pix.numel()) for pix, _, _ in
                             raster_cuda._covered_pairs(
                                 vis, work, width, height, tile, 1 << 21)),
        "evaluated_pairs": int(raster_cuda.block_pair_rects(
            vis, work, width, height, tile).cnt.sum()),
        "bbox_pairs": int(raster_cuda.pair_rects(vis, work, width, height,
                                                 tile).cnt.sum()),
    }
    # the most evaluated pairs one 64-px region holds: what its cluster
    # of blocks alone must evaluate
    rects = raster_cuda.block_pair_rects(vis, work, width, height, tile, 64)
    region = rects.y0 // 64 * -(-width // 64) + rects.x0 // 64
    pairs["busiest_region_pairs"] = int(torch.bincount(
        region, weights=rects.cnt.double()).max()) if region.numel() else 0
    return work.items.numel() * 4 + n_inst * vis.shape[1] * VIS_BYTES, pairs


def pairs_text(pairs: dict) -> str:
    return (f"(triangle, pixel) pairs covered {pairs['covered_pairs']}, "
            f"evaluated {pairs['evaluated_pairs']} after the block test "
            f"({pairs['busiest_region_pairs']} in the busiest 64-px region), "
            f"{pairs['bbox_pairs']} in bboxes")


def layout_times(fn, check) -> dict:
    """CUDA-event ms of ``fn(region=side, cluster=n)`` for each layout of
    LAYOUTS, after ``check`` holds each layout's output to the reference."""
    out = {}
    for side, n in LAYOUTS:
        key = f"{side}px x{n}"
        check(fn(region=side, cluster=n), key)
        out[key] = cuda_ms(lambda: fn(region=side, cluster=n), 20)
    return out


def sass_atomics() -> str:
    """The shared-memory atomic instructions each region kernel compiled
    to, from cuobjdump's SASS of the built library."""
    from vrenderer_tpu_torch.probes import common

    named = {}
    for fn, ops in common.sass_ops(r"region_kernel",
                                   r"ATOMS\.[A-Z0-9.]+").items():
        i = int(re.search(r"region_kernelILi(\d)E", fn).group(1))
        named[f"region_kernel<{('B1', 'B3a', 'B2')[i]}>"] = ops
    return "; ".join(f"{k}: " + ", ".join(f"{op} x{n}" for op, n in v.items())
                     for k, v in sorted(named.items()))


def winner_bytes(ids) -> int:
    """Bytes of the attribute coefficients of the distinct winners."""
    import torch

    return int(torch.unique(ids[ids >= 0]).numel()) * COEF_BYTES


def per_camera(per_cam) -> dict:
    """One kernel's JSON numbers from its per-camera ones (in
    KERNEL_CAMERAS order): camera JSON_CAMERA's at the top level, so that
    every number and ``bound_by`` there belong to one view, and each
    camera's under ``cameras``."""
    by_cam = dict(zip(KERNEL_CAMERAS, per_cam))
    return {**by_cam[JSON_CAMERA], "camera": JSON_CAMERA,
            "cameras": {str(c): d for c, d in by_cam.items()}}


def bench_renderer(device, max_active=MAX_ACTIVE, **cfg_kw):
    """A bench.py renderer, parameters and cameras (bench.py:97-159);
    ``cfg_kw`` selects the shadow mode."""
    from vrenderer_tpu_torch.camera import flythrough
    from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings
    from vrenderer_tpu_torch.models.scene import Scene
    from vrenderer_tpu_torch.renderer import FrameParams, Renderer
    from vrenderer_tpu_torch.terrain import heightmap as hmod

    ts = TerrainSettings(max_instances=1024)
    cfg = FrameConfig(width=WIDTH, height=HEIGHT, terrain=ts, **cfg_kw)
    hm = hmod.procedural_heightmap(256, device=device)
    alb = hmod.procedural_albedo(hm)
    r = Renderer(cfg, hm, alb, max_work=MAX_WORK, max_active=max_active,
                 scene=Scene.default(device), device=device)
    params = FrameParams.default(r.light, device)
    cams = flythrough(64, heightmap=hm, max_height=400.0,
                      world_size=ts.world_size)
    return r, params, cams


def b1_vs_plain(label: str, packed, work, width: int, height: int,
                tile: int, layouts: bool = True) -> dict:
    """Kernel B1 against its plain version at (``packed``, ``work``): ids
    and z equal, attrs within ATTR_TOL, the launch counted; CUDA-event
    times of both (and of each layout of LAYOUTS with ``layouts``), the
    pairs and the bound. Returns the JSON numbers."""
    import torch

    from vrenderer_tpu_torch.ops import raster_cuda

    args = (width, height, tile)
    ref = raster_cuda.rasterize_plain(packed, work, *args)
    before = raster_cuda.rasterize.launches
    out = raster_cuda.rasterize(packed, work, *args)
    torch.cuda.synchronize()
    if raster_cuda.rasterize.launches != before + 1:
        raise RuntimeError("the raster wrapper did not count its launch")
    if not torch.equal(out[1], ref[1]):
        n = int((out[1] != ref[1]).sum())
        raise RuntimeError(f"{label}: {n} prim ids differ from plain")
    if not torch.equal(out[0], ref[0]):
        raise RuntimeError(f"{label}: z differs from plain")
    err = float((out[2] - ref[2]).abs().max())
    if not err <= ATTR_TOL:
        raise RuntimeError(f"{label}: attrs differ by {err}")

    def same(o, layout):
        if not all(torch.equal(a, b) for a, b in zip(o, out)):
            raise RuntimeError(f"{label}: B1 with layout {layout} differs")

    lay = (layout_times(lambda **kw: raster_cuda.rasterize(
        packed, work, *args, **kw), same) if layouts else {})
    k_ms = cuda_ms(lambda: raster_cuda.rasterize(packed, work, *args), 20)
    p_ms = cuda_ms(lambda: raster_cuda.rasterize_plain(packed, work, *args),
                   3, queued=False)
    n_px = int((out[1] >= 0).sum())
    in_bytes, pairs = raster_work(packed.vis, work, *args)
    b = bound(in_bytes + winner_bytes(out[1]) + width * height * 40,
              pairs["covered_pairs"] * PAIR_OPS + n_px * RESOLVE_OPS)
    log(f"kernel {label}: ids/z equal, attrs max abs err {err:.3g}, "
        f"instance slots {packed.vis.shape[0]} of {packed.vis.shape[1]} "
        f"triangles, work items {int(work.num_items)}, covered "
        f"{n_px / (width * height):.4f}, {pairs_text(pairs)}; kernel "
        f"{k_ms:.4f} ms"
        + (" (layouts " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                    lay.items()) + ")" if lay else "")
        + f", plain {p_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']})")
    out = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **b, **pairs}
    if lay:
        out["layout_ms"] = lay
    return out


def phase_kernel(name, r, params, prepass, cams) -> dict:
    """Kernel B1 against its plain version at the inputs the ``name`` path
    gives it."""
    cfg = r.config
    return per_camera([b1_vs_plain(
        f"({name} path) camera {i}",
        *r.raster_inputs(cams.frame(i), params, prepass), cfg.width,
        cfg.height, cfg.raster.tile_w) for i in KERNEL_CAMERAS])


def phase_golden(device) -> None:
    """tests/test_golden.py's frame through the kernel, held to the stored
    frames (see tests/test_torch_frame.py for the bounds' reasons)."""
    import torch

    from vrenderer_tpu_torch.camera import Camera
    from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings
    from vrenderer_tpu_torch.ops import raster_cuda
    from vrenderer_tpu_torch.renderer import FrameParams, Renderer
    from vrenderer_tpu_torch.terrain import heightmap as hmod

    cfg = FrameConfig(width=256, height=128, terrain=TerrainSettings(
        surface_size=64, world_size=64, max_instances=64, grid_size=8))
    hm = hmod.procedural_heightmap(64, seed=7, device=device)
    r = Renderer(cfg, hm, hmod.procedural_albedo(hm), device=device)

    def v(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    cam = Camera(eye=v([0.0, 25.0, 45.0]), target=v([0.0, 0.0, 0.0]),
                 up=v([0.0, 1.0, 0.0]))
    before = raster_cuda.rasterize.launches
    out = r.render(cam, FrameParams.default(device=device)._replace(
        max_height=v(12.0)))
    torch.cuda.synchronize()
    if raster_cuda.rasterize.launches != before + 1:
        raise RuntimeError("the golden frame did not launch the kernel")
    ldr = out.ldr.cpu().numpy()
    prim = out.prim_id.cpu().numpy()
    golden = np.load(REPO / "tests" / "golden_frame.npy").astype(np.float32)
    ref = np.load(REPO / "tests" / "golden_frame_unfused.npz")
    d = np.abs(ldr - golden)
    du = np.abs(ldr - ref["ldr"].astype(np.float32))
    cov = float((prim >= 0).mean())
    same = prim == ref["prim_id"]
    log(f"golden frame: vs golden_frame.npy max {d.max():.4g} mean "
        f"{d.mean():.4g} ({int((d.max(-1) >= 5e-3).sum())} px >= 5e-3); "
        f"vs op-by-op JAX frame max {du.max():.4g} (same owner "
        f"{du[same].max():.4g}) mean {du.mean():.4g}, prim ids equal "
        f"{same.mean():.6f}; coverage {cov:.6f}; "
        f"prim[64,128]={prim[64, 128]} prim[100,200]={prim[100, 200]}")
    if not (d.mean() < 5e-4 and abs(cov - 0.552856) <= 0.002
            and prim[64, 128] == 2144 and prim[100, 200] == 3589):
        raise RuntimeError("golden frame outside test_golden.py's bounds")
    # the card's exp/pow/sin and its matmul sums round in other last bits
    # than the CPU's: a silhouette pixel may change owner, hence the count;
    # where the owner agrees the value bound holds
    if not (same.mean() >= 0.999 and du[same].max() < 5e-3):
        raise RuntimeError("golden frame differs from the op-by-op JAX frame")


def reset_launches() -> None:
    from vrenderer_tpu_torch.ops import raster_cuda

    for fn in launch_counted():
        fn.launches = 0


def launch_counted():
    from vrenderer_tpu_torch.ops import raster_cuda

    return (raster_cuda.rasterize, raster_cuda.rasterize_depth,
            raster_cuda.rasterize_zid, raster_cuda.filter_work_to_winners,
            raster_cuda.rasterize_resolve)


def read_launches() -> dict:
    return dict(zip(("raster", "raster_depth", "raster_zid",
                     "raster_filter", "raster_resolve"),
                    (fn.launches for fn in launch_counted())))


def launches(raster=0, raster_depth=0, raster_zid=0, raster_filter=0,
             raster_resolve=0):
    """The expected counts of ``read_launches``."""
    return {"raster": raster, "raster_depth": raster_depth,
            "raster_zid": raster_zid, "raster_filter": raster_filter,
            "raster_resolve": raster_resolve}


def phase_flythrough(name, r, params, cams, prepass=None, frames=None,
                     keep=None):
    """The flythrough frames ``frames`` (default all 64) after a warm-up
    frame; returns the CUDA-event frame times and the kernel launches of
    the run. ``keep``, a list, receives each frame's output."""
    import torch

    frames = range(cams.eye.shape[0]) if frames is None else frames
    reset_launches()
    r.render(cams.frame(frames[0]), params, shadow_prepass=prepass)  # warm-up
    times, stats = [], []
    for i in frames:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = r.render(cams.frame(i), params, shadow_prepass=prepass)
        end.record()
        stats.append(torch.stack([
            torch.isfinite(out.ldr).all().float(),
            torch.isfinite(out.hdr).all().float(),
            (out.prim_id >= 0).float().mean(),
            out.overflow_mask.float(),
            out.num_work_items.float(),
            out.num_instances.float(),
        ]))
        times.append((start, end))
        if keep is not None:
            keep.append(out)
    torch.cuda.synchronize()
    launched = read_launches()
    ms = [s.elapsed_time(e) for s, e in times]
    st = torch.stack(stats).cpu().numpy()
    for i, (fin_l, fin_h, cov, mask, n_work, n_inst) in zip(frames, st):
        if not (fin_l == 1 and fin_h == 1 and 0.0 < cov < 1.0 and mask == 0
                and n_work <= r.max_work):
            raise RuntimeError(
                f"{name} frame {i}: finite ldr/hdr {bool(fin_l)}/"
                f"{bool(fin_h)}, coverage {cov}, overflow mask {int(mask)}, "
                f"work items {int(n_work)}, instances {int(n_inst)} "
                f"(max_work {r.max_work}, max_active {r.max_active})")
    log(f"{name} path: {len(ms)} frames finite, no overflow; coverage "
        f"{st[:, 2].min():.4f}-{st[:, 2].max():.4f}, work items "
        f"{int(st[:, 4].min())}-{int(st[:, 4].max())}, instances "
        f"{int(st[:, 5].min())}-{int(st[:, 5].max())}; launches {launched}")
    return ms, launched


def phase_modes_kernel(r, params, prepass, cams) -> None:
    """Kernel B1 under reverse-z and in wireframe (timed with CUDA events),
    and kernel B3a under reverse-z, against their plain versions at the
    horizon path's inputs: ids and z equal, attrs within ATTR_TOL."""
    import torch

    from vrenderer_tpu_torch.ops import raster_cuda

    cfg = r.config
    args = (cfg.width, cfg.height, cfg.raster.tile_w)
    for i in KERNEL_CAMERAS:
        packed, work = r.raster_inputs(cams.frame(i), params, prepass)
        msg, b1 = [], {}
        for name, mode in (("reverse-z", {"reverse_z": True}),
                           ("wireframe", {"wire_px": 1.0})):
            out = raster_cuda.rasterize(packed, work, *args, **mode)
            ref = raster_cuda.rasterize_plain(packed, work, *args, **mode)
            err = float((out[2] - ref[2]).abs().max())
            if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
                    and err <= ATTR_TOL):
                raise RuntimeError(f"camera {i}: B1 {name} differs from "
                                   f"plain (attrs {err})")
            k_ms = cuda_ms(lambda: raster_cuda.rasterize(packed, work, *args,
                                                         **mode), 20)
            msg.append(f"B1 {name} ids/z equal, attrs max abs err {err:.3g}, "
                       f"covered {float((out[1] >= 0).float().mean()):.4f}, "
                       f"kernel {k_ms:.4f} ms")
            b1[name] = out
        z, ids = raster_cuda.rasterize_zid(packed, work, *args,
                                           reverse_z=True)
        zp, idp = raster_cuda.rasterize_zid_plain(packed, work, *args,
                                                  reverse_z=True)
        if not (torch.equal(z, zp) and torch.equal(ids, idp)
                and torch.equal(z, b1["reverse-z"][0])
                and torch.equal(ids, b1["reverse-z"][1])):
            raise RuntimeError(f"camera {i}: B3a reverse-z differs from plain "
                               f"or from B1")
        log(f"modes camera {i}: {'; '.join(msg)}; B3a reverse-z z/ids equal "
            f"to plain and to B1's")


def two_phase_vs_plain(label: str, packed, work, W: int, H: int, tile: int,
                       cells: dict):
    """Kernels B3a, the winner filter and B3b at (``packed``, ``work``), a
    W x H target: B3a's z and id bitwise equal to its plain version and to
    B1's, the filter kernel's work list and live (item, cell) pairs equal
    to its plain version, B3b's attrs bitwise equal to its plain version
    and to B1's, the two-phase raster equal to B1; CUDA-event times of
    B3a, the filter, B3b, the whole two-phase raster and B1. Returns the
    JSON numbers of B3a and of B3b (with the filter's)."""
    import torch

    from vrenderer_tpu_torch.ops import raster_cuda

    T = packed.vis.shape[1]
    b1 = raster_cuda.rasterize(packed, work, W, H, tile)
    z, ids = raster_cuda.rasterize_zid(packed, work, W, H, tile)
    zp, idp = raster_cuda.rasterize_zid_plain(packed, work, W, H, tile)
    if not (torch.equal(z, zp) and torch.equal(ids, idp)):
        raise RuntimeError(f"{label}: B3a differs from plain")
    if not (torch.equal(z, b1[0]) and torch.equal(ids, b1[1])):
        raise RuntimeError(f"{label}: B3a differs from B1's z/id")
    before = raster_cuda.filter_work_to_winners.launches
    work2, live = raster_cuda.filter_work_to_winners(work, ids, T, W, H,
                                                     tile, **cells)
    torch.cuda.synchronize()
    if raster_cuda.filter_work_to_winners.launches != before + 1:
        raise RuntimeError("the filter wrapper did not count its launch")
    wp, lp = raster_cuda.filter_work_to_winners_plain(work, ids, T, W, H,
                                                      tile, **cells)
    if not (torch.equal(work2.items, wp.items) and torch.equal(live, lp)
            and torch.equal(work2.num_items, wp.num_items)):
        raise RuntimeError(f"{label}: the filter kernel differs from plain")
    attrs = raster_cuda.rasterize_resolve(packed, work2, live, ids, W, H,
                                          tile, **cells)
    ap = raster_cuda.rasterize_resolve_plain(packed, work2, live, ids, W, H,
                                             tile, **cells)
    if not torch.equal(attrs, ap):
        raise RuntimeError(f"{label}: B3b differs from plain")
    if not torch.equal(attrs, b1[2]):
        raise RuntimeError(f"{label}: B3b differs from B1's attrs")
    two = raster_cuda.rasterize_two_phase(packed, work, W, H, tile,
                                          reverse_z=False, **cells)
    if not all(torch.equal(a, b) for a, b in zip(two, b1)):
        raise RuntimeError(f"{label}: two-phase differs from B1")

    t = {
        "b3a": cuda_ms(lambda: raster_cuda.rasterize_zid(
            packed, work, W, H, tile), 20),
        "filter": cuda_ms(lambda: raster_cuda.filter_work_to_winners(
            work, ids, T, W, H, tile, **cells), 20),
        "b3b": cuda_ms(lambda: raster_cuda.rasterize_resolve(
            packed, work2, live, ids, W, H, tile, **cells), 20),
        "two_phase": cuda_ms(lambda: raster_cuda.rasterize_two_phase(
            packed, work, W, H, tile, **cells), 20),
        "b1": cuda_ms(lambda: raster_cuda.rasterize(
            packed, work, W, H, tile), 20),
        "b3a_plain": cuda_ms(lambda: raster_cuda.rasterize_zid_plain(
            packed, work, W, H, tile), 3, queued=False),
        "filter_plain": cuda_ms(
            lambda: raster_cuda.filter_work_to_winners_plain(
                work, ids, T, W, H, tile, **cells), 20, queued=False),
        "b3b_plain": cuda_ms(lambda: raster_cuda.rasterize_resolve_plain(
            packed, work2, live, ids, W, H, tile, **cells), 3,
            queued=False),
    }
    used = int((work.items[:, 0] >= 0).sum())
    n_live = int(live.sum())
    n_px = int((ids >= 0).sum())
    in_bytes, pairs = raster_work(packed.vis, work, W, H, tile)
    b_zid = bound(in_bytes + W * H * 8, pairs["covered_pairs"] * PAIR_OPS)
    b_res = bound(W * H * (4 + 32) + winner_bytes(ids) + live.numel()
                  + work2.items.numel() * 4, n_px * RESOLVE_OPS)
    # the filter reads the ids and the work list, writes both outputs
    b_fil = bound(W * H * 4 + work.items.numel() * 8 + live.numel(), 0)
    log(f"two-phase kernels {label}: B3a z/id equal to plain and "
        f"B1, the filter's work list and live pairs equal to plain, B3b "
        f"attrs equal to plain and B1, two-phase "
        f"equal to B1; live (item, cell) pairs {n_live} of "
        f"{used * live.shape[1]} "
        f"({n_live / max(used * live.shape[1], 1):.4f}), live items "
        f"{int((work2.items[:, 0] >= 0).sum())} of {used}; "
        f"{pairs_text(pairs)}; "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
        + f"; bound B3a {b_zid['bound_ms']:.4f} ms "
        f"({b_zid['bound_by']}), filter {b_fil['bound_ms']:.4f} ms "
        f"({b_fil['bound_by']}), B3b {b_res['bound_ms']:.4f} ms "
        f"({b_res['bound_by']}); chain / B1 "
        f"{t['two_phase'] / t['b1']:.3f}")
    return ({"max_abs_err": float((z - zp).abs().max()), "ms": t["b3a"],
             "plain_ms": t["b3a_plain"], **b_zid, **pairs},
            {"max_abs_err": float((attrs - ap).abs().max()), "ms": t["b3b"],
             "plain_ms": t["b3b_plain"], **b_res, "filter_ms": t["filter"],
             "filter_plain_ms": t["filter_plain"],
             "filter_bound_ms": b_fil["bound_ms"],
             "chain_ms": t["two_phase"], "b1_ms": t["b1"]})


def phase_two_phase_kernels(r, params, prepass, cams):
    """``two_phase_vs_plain`` at the horizon path's inputs. Returns the
    JSON numbers of B3a and B3b (with the filter's)."""
    cfg = r.config
    rs = cfg.raster
    cells = dict(sub_h=rs.subtile_h, win_w=rs.win_w)
    zid_cam, res_cam = [], []
    for i in KERNEL_CAMERAS:
        zid, res = two_phase_vs_plain(
            f"camera {i}", *r.raster_inputs(cams.frame(i), params, prepass),
            cfg.width, cfg.height, rs.tile_w, cells)
        zid_cam.append(zid)
        res_cam.append(res)
    return per_camera(zid_cam), per_camera(res_cam)


def phase_two_phase_path(device, params, cams, single) -> list:
    """The slice's path: the 1080p horizon flythrough with
    ``RasterSettings(two_phase=True)``, the boot cube and the cached
    prepass, all 64 cameras and a warm-up frame; each frame's ldr, depth,
    prim_id and overflow mask bit-identical to the single-phase frame in
    ``single``. Returns the frame times and launches."""
    import torch

    from vrenderer_tpu_torch.config import RasterSettings

    r, _, _ = bench_renderer(device, raster=RasterSettings(two_phase=True))
    prepass = r.cached_horizon_prepass(params)
    outs = []
    ms, launched = phase_flythrough("two-phase horizon", r, params, cams,
                                    prepass, keep=outs)
    n = cams.eye.shape[0] + 1           # the frames and the warm-up frame
    if launched != launches(raster_zid=n, raster_filter=n, raster_resolve=n):
        raise RuntimeError(f"two-phase path launches {launched}")
    for i, (a, b) in enumerate(zip(outs, single)):
        for f in ("ldr", "depth", "prim_id", "overflow_mask"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise RuntimeError(f"two-phase frame {i}: {f} differs from "
                                   f"the single-phase frame")
    log(f"two-phase horizon path: {len(outs)} frames bit-identical to the "
        f"single-phase frames (ldr, depth, prim_id, overflow_mask)")
    return ms, launched


def phase_mode_frames(device, params, cams) -> None:
    """A few 1080p horizon frames with reverse-z and in wireframe: finite,
    covered in (0, 1), no overflow, one B1 launch each."""
    from vrenderer_tpu_torch.config import RasterSettings

    for name, kw in (("reverse-z", {"reverse_z": True}),
                     ("wireframe", {"wireframe": True})):
        r, _, _ = bench_renderer(device, raster=RasterSettings(**kw))
        prepass = r.cached_horizon_prepass(params)
        ms, launched = phase_flythrough(f"{name} horizon", r, params, cams,
                                        prepass, frames=MODE_CAMERAS)
        if launched != launches(raster=len(MODE_CAMERAS) + 1):
            raise RuntimeError(f"{name} frames launches {launched}")
        log(f"{name} frame times (cameras {MODE_CAMERAS}): "
            + ", ".join(f"{m:.3f} ms" for m in ms))


def b2_vs_plain(label: str, vis, work, res: int, tile: int,
                layouts: bool = True) -> dict:
    """Kernel B2 against its plain version and kernel B1's z at (``vis``,
    ``work``), a res x res light view: z bitwise equal to both, the
    background F32_FAR; CUDA-event times (and each layout's), pairs and
    bound. Returns the JSON numbers."""
    import torch

    from vrenderer_tpu_torch.ops import raster_cuda

    args = (res, res, tile)
    ref = raster_cuda.rasterize_depth_plain(vis, work, *args)
    before = raster_cuda.rasterize_depth.launches
    z = raster_cuda.rasterize_depth(vis, work, *args)
    torch.cuda.synchronize()
    if raster_cuda.rasterize_depth.launches != before + 1:
        raise RuntimeError("the depth wrapper did not count its launch")
    if not torch.equal(z, ref):
        n = int((z != ref).sum())
        raise RuntimeError(f"{label}: {n} depth pixels differ from plain")
    coef = torch.zeros(vis.shape[:2] + (raster_cuda.NUM_COEF,),
                       device=vis.device)
    z_b1 = raster_cuda.rasterize(raster_cuda.PackedTris(vis, coef), work,
                                 *args)[0]
    if not torch.equal(z, z_b1):
        raise RuntimeError(f"{label}: depth differs from B1's z")
    if not bool(torch.all((z < 2.0) | (z == raster_cuda.F32_FAR))):
        raise RuntimeError(f"{label}: background is not F32_FAR")
    err = float((z - ref).abs().max())

    def same(o, layout):
        if not torch.equal(o, z):
            raise RuntimeError(f"{label}: B2 with layout {layout} differs")

    lay = (layout_times(lambda **kw: raster_cuda.rasterize_depth(
        vis, work, *args, **kw), same) if layouts else {})
    k_ms = cuda_ms(lambda: raster_cuda.rasterize_depth(vis, work, *args), 20)
    p_ms = cuda_ms(lambda: raster_cuda.rasterize_depth_plain(vis, work, *args),
                   3, queued=False)
    covered = float((z < 2.0).float().mean())
    in_bytes, pairs = raster_work(vis, work, *args)
    b = bound(in_bytes + res * res * 4, pairs["covered_pairs"] * PAIR_OPS)
    log(f"depth kernel {label}: z equal to plain and to B1, work items "
        f"{int(work.num_items)}, covered {covered:.4f}, {pairs_text(pairs)}; "
        f"kernel {k_ms:.4f} ms"
        + (" (layouts " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                    lay.items()) + ")" if lay else "")
        + f", plain {p_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']})")
    out = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **b, **pairs}
    if lay:
        out["layout_ms"] = lay
    return out


def phase_depth_kernel(r, params, cams) -> dict:
    """Kernel B2 against its plain version and kernel B1's z at the map
    cell's light-pass inputs."""
    res = r.config.shadow_resolution
    return per_camera([b2_vs_plain(
        f"camera {i} (max_work {r.max_work})",
        *r.light_raster_inputs(cams.frame(i), params), res,
        r.config.raster.tile_w) for i in KERNEL_CAMERAS])


def map_golden_renderer(device):
    """The renderer of the map golden frame (tests/test_torch_map_frame.py
    holds it to the same file on the CPU): the small terrain at 256x128
    with a 128x128 light map and a cube in view."""
    import torch

    from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings
    from vrenderer_tpu_torch.models import mesh, scene
    from vrenderer_tpu_torch.renderer import Renderer
    from vrenderer_tpu_torch.terrain import heightmap as hmod
    from vrenderer_tpu_torch.utils import math3d

    cfg = FrameConfig(width=256, height=128, terrain=TerrainSettings(
        surface_size=64, world_size=64, max_instances=64, grid_size=8),
        shadow_mode="map", shadow_resolution=128)
    hm = hmod.procedural_heightmap(64, seed=7, device=device)
    cube = scene.MeshInstance(
        mesh=mesh.cube(6.0, color=(0.9, 0.05, 0.05), device=device),
        transform=math3d.affine_translation(torch.tensor(
            [4.0, 17.0, 6.0], dtype=torch.float32, device=device)))
    return Renderer(cfg, hm, hmod.procedural_albedo(hm),
                    scene=scene.Scene(instances=[cube]), device=device)


def phase_map_golden(device) -> None:
    """The map golden frame (bounds and their reasons in
    tests/test_torch_map_frame.py): through the stored JAX light pass, the
    frame bounds of phase 4; through the card's own light pass (kernel
    B2), the covered and cube pixels, and the light map's coverage and
    heights."""
    import torch

    from vrenderer_tpu_torch import convert
    from vrenderer_tpu_torch.camera import Camera
    from vrenderer_tpu_torch.ops import raster_cuda
    from vrenderer_tpu_torch.renderer import FrameParams

    def v(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    g = np.load(REPO / "tests" / "golden_map_frame_unfused.npz")
    r = map_golden_renderer(device)
    cam = Camera(eye=v([0.0, 25.0, 45.0]), target=v([0.0, 0.0, 0.0]),
                 up=v([0.0, 1.0, 0.0]))
    params = FrameParams.default(device=device)._replace(max_height=v(12.0))
    n_terrain = 64 * r.config.terrain.tris_per_instance
    pre = convert.shadow_prepass(g["depth"], g["wtc"], g["z_range"],
                                 g["overflow"], g["shear"], device=device)
    out = r.render(cam, params, shadow_prepass=pre)
    prim = out.prim_id.cpu().numpy()
    same = prim == g["prim_id"]
    d = np.abs(out.ldr.cpu().numpy() - g["ldr"].astype(np.float32))
    before = read_launches()
    inline = r.render(cam, params)
    res = r.config.shadow_resolution
    depth = raster_cuda.rasterize_depth(*r.light_raster_inputs(cam, params),
                                        res, res).cpu().numpy()
    default = r.render_shadow_depth(params).cpu().numpy()
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in read_launches().items()}
    cls = [((inline.prim_id.cpu().numpy() >= lo) == (g["prim_id"] >= lo))
           .mean() for lo in (0, n_terrain)]
    d_inline = np.abs(inline.ldr.cpu().numpy() - g["ldr"].astype(np.float32))
    maps = []
    for z, ref in ((depth, g["depth"]), (default, g["depth_default"])):
        cov, ref_cov = z < 2.0, ref < 2.0
        dz = np.abs(z - ref)[cov & ref_cov]
        maps.append(((cov == ref_cov).mean(), (dz <= 1e-4).mean(),
                     np.median(dz)))
    log(f"map golden frame: via the stored light pass prim ids equal "
        f"{same.mean():.6f}, ldr max {d.max():.4g} (same owner "
        f"{d[same].max():.4g}) mean {d.mean():.4g}, cube px "
        f"{int((prim >= n_terrain).sum())}; inline covered/cube px agree "
        f"{cls[0]:.6f}/{cls[1]:.6f}, ldr mean {d_inline.mean():.4g}; light "
        f"map (camera eye / default eye) coverage agrees "
        f"{maps[0][0]:.6f}/{maps[1][0]:.6f}, |dz| <= 1e-4 on "
        f"{maps[0][1]:.4f}/{maps[1][1]:.4f} (median {maps[0][2]:.3g}/"
        f"{maps[1][2]:.3g}); launches {launched}")
    if launched != launches(raster=1, raster_depth=3):
        raise RuntimeError("the inline map frame did not run both kernels")
    if not (same.mean() >= 0.999 and d[same].max() < 5e-3
            and d.mean() < 5e-4 and (prim >= n_terrain).sum() > 200):
        raise RuntimeError("map golden frame outside its bounds")
    # tests/test_torch_map_frame.py: the JAX package's jitted light pass
    # is within 1e-4 of its op-by-op pass at 96.6% / 93.8% of the pixels,
    # and its jitted frame 1.3e-3 off in mean ldr
    if not (min(cls) >= 0.999 and d_inline.mean() < 1e-3
            and all(c >= 0.999 and s >= 0.99 for c, s, _ in maps)):
        raise RuntimeError("the card's light pass differs from the golden")


def phase_map_cached(device, params, cams) -> None:
    """mapcache: the light-eye map rastered once serves every frame, and
    cached frames are bit-identical to inline ones."""
    import torch

    r, _, _ = bench_renderer(device, max_active=MAP_MAX_ACTIVE,
                             shadow_mode="map", shadow_resolution=SHADOW_RES,
                             shadow_select="light")
    reset_launches()
    cached = []
    for i in range(CACHED_CAMERAS):
        out = r.render(cams.frame(i), params,
                       shadow_prepass=r.cached_shadow_prepass(params))
        cached.append(out)
    torch.cuda.synchronize()
    launched = read_launches()
    if launched != launches(raster=CACHED_CAMERAS, raster_depth=1):
        raise RuntimeError(f"cached loop launches {launched}")
    for i, out in enumerate(cached):
        inline = r.render(cams.frame(i), params)
        for f in ("ldr", "hdr", "depth", "prim_id", "overflow_mask"):
            if not torch.equal(getattr(out, f), getattr(inline, f)):
                raise RuntimeError(f"cached frame {i}: {f} differs from the "
                                   f"inline frame")
        if int(out.overflow_mask) != 0:
            raise RuntimeError(f"cached frame {i}: overflow mask "
                               f"{int(out.overflow_mask)}")
    # the light-eye map depends on no camera: the standalone light view is
    # the cached one
    if not torch.equal(r.render_shadow_depth(params),
                       r.cached_shadow_prepass(params)[0]):
        raise RuntimeError("render_shadow_depth differs from the prepass")
    log(f"map cached variant: {CACHED_CAMERAS} cached frames bit-identical "
        f"to inline frames; cached loop launches {launched}; "
        f"render_shadow_depth equals the cached map")


def frame_stats(outs, name: str) -> str:
    """Every frame finite, covered in (0, 1) and without overflow (at the
    App's own budgets, max_active = max_instances)."""
    import torch

    st = torch.stack([torch.stack([
        torch.isfinite(o.ldr).all().float(),
        torch.isfinite(o.hdr).all().float(),
        (o.prim_id >= 0).float().mean(), o.overflow_mask.float()])
        for o in outs]).cpu().numpy()
    for i, (fin_l, fin_h, cov, mask) in enumerate(st):
        if not (fin_l == 1 and fin_h == 1 and 0.0 < cov < 1.0 and mask == 0):
            raise RuntimeError(f"{name} frame {i}: finite ldr/hdr "
                               f"{bool(fin_l)}/{bool(fin_h)}, coverage {cov}, "
                               f"overflow mask {int(mask)}")
    return (f"{len(outs)} frames finite, no overflow, coverage "
            f"{st[:, 2].min():.4f}-{st[:, 2].max():.4f}")


def app_run(app, name: str, **kw):
    """``app.run_flythrough(**kw)`` with the kernel launches counted from 0
    and its host times: (outputs, launches, seconds, frame ms of the loop's
    frames, the "Wait GPU" share of the run's host time)."""
    import torch

    reset_launches()
    n_ev = len(app.profiler.native_events())
    t0 = time.perf_counter()
    outs = app.run_flythrough(**kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launched = read_launches()
    frame_ms = app.profiler.frame_times_ms[-kw["num_frames"] - 1:-1]
    evs = app.profiler.native_events()[n_ev:]
    wait = sum(e["end_ns"] - e["begin_ns"] for e in evs
               if e["name"] == "Wait GPU") * 1e-6
    total = sum(app.profiler.frame_times_ms[-kw["num_frames"] - 1:])
    if launched["raster"] == 0:
        raise RuntimeError(f"{name}: kernel B1 was not launched")
    return outs, launched, sec, frame_ms, wait / total


def device_trace(app, cams, prepass) -> dict:
    """A ``torch.profiler`` trace of the App's adapting frame at
    TRACE_CAMERAS: device kernels and busy ms (the union of kernel, copy
    and set intervals) per frame, the busy share of the frames' CUDA-event
    time with and without the profiler, and the ten kernels with the most
    device time."""
    import tempfile

    import torch

    from vrenderer_tpu_torch.profiler import (
        start_device_trace, stop_device_trace,
    )

    r, params = app.renderer, app.params
    lum = torch.tensor(0.5, device=app.device)

    def frames():
        ms = []
        for i in TRACE_CAMERAS:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r.render_adaptive(cams.frame(i), params, lum, APP_DT,
                              shadow_prepass=prepass)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        return ms

    frames()
    plain_ms = frames()
    with tempfile.TemporaryDirectory() as tmp:
        start_device_trace(tmp)
        traced_ms = frames()
        stop_device_trace()
        with open(Path(tmp) / "trace.json") as fh:
            events = json.load(fh)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    if not kernels:
        raise RuntimeError("the device trace holds no kernel")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    n = len(TRACE_CAMERAS)
    by_name = Counter()
    for e in kernels:
        by_name[e["name"]] += float(e["dur"])
    busy_ms = busy * 1e-3 / n
    return {
        "frames": list(TRACE_CAMERAS),
        "kernels_per_frame": len(kernels) / n,
        "copies_sets_per_frame": (len(dev) - len(kernels)) / n,
        "busy_ms_per_frame": busy_ms,
        "frame_ms": plain_ms, "frame_ms_traced": traced_ms,
        "busy_share": busy_ms / float(np.mean(plain_ms)),
        "busy_share_traced": busy_ms / float(np.mean(traced_ms)),
        "top_kernels_ms_per_frame": [
            [k[:120], v * 1e-3 / n] for k, v in by_name.most_common(10)],
    }


def phase_app(device, card: str) -> None:
    """Phase 12 (module docstring)."""
    import tempfile

    import torch

    from vrenderer_tpu_torch.app import App
    from vrenderer_tpu_torch.camera import flythrough
    from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings
    from vrenderer_tpu_torch.models.scene import Scene
    from vrenderer_tpu_torch.renderer import Renderer
    from vrenderer_tpu_torch.terrain.heightmap import load_png

    t0 = time.perf_counter()
    cfg = FrameConfig(width=WIDTH, height=HEIGHT,
                      terrain=TerrainSettings(max_instances=1024))
    app = App(cfg, scene=Scene.default(device), device=device)
    r = app.renderer

    # run 1: PNGs, trace, native ring (and the warm-up of runs 2 and 3)
    with tempfile.TemporaryDirectory() as tmp:
        outs, launched, sec, _, _ = app_run(
            app, "app run 1", num_frames=APP_DUMP_FRAMES, dump_dir=tmp,
            trace_path=f"{tmp}/trace.json")
        for i, o in enumerate(outs):
            ldr = o.ldr.cpu().numpy()
            want = ((np.clip(ldr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
                    .astype(np.float32) / np.float32(255.0))
            got = load_png(f"{tmp}/frame_{i:04d}.png").numpy()
            if not np.array_equal(got, want):
                raise RuntimeError(f"app frame {i}: the PNG read back "
                                   f"differs from the 8-bit frame")
        with open(f"{tmp}/trace.json") as fh:
            names = {e["name"] for e in json.load(fh)["traceEvents"]}
    scopes = {"Render", "Wait GPU", "Present", "CPU Frame"}
    if not scopes <= names:
        raise RuntimeError(f"the chrome trace lacks {scopes - names}")
    n_native = len(app.profiler.native_events())
    if n_native == 0:
        raise RuntimeError("the native event ring is empty")
    log(f"app run 1: {frame_stats(outs, 'app run 1')}; {len(outs)} PNGs "
        f"read back through load_png equal to the 8-bit frames; chrome "
        f"trace scopes {sorted(names)}; {n_native} native events; launches "
        f"{launched}; {sec:.1f} s")
    del outs

    # run 2: adapting, against a hand-threaded render_adaptive chain
    t1 = time.perf_counter()
    outs, launched, sec, ms2, wait2 = app_run(app, "app run 2",
                                              num_frames=APP_FRAMES)
    stats2 = frame_stats(outs, "app run 2")
    del outs
    hist = np.asarray(app.adapt_history)
    if launched != launches(raster=APP_FRAMES):
        raise RuntimeError(f"app run 2 launches {launched}")
    if not (hist.shape == (APP_FRAMES,) and np.isfinite(hist).all()
            and abs(hist[-1] - 0.5) > 1e-3):
        raise RuntimeError(f"adapt_history {hist}")
    cams = flythrough(APP_FRAMES, world_size=cfg.terrain.world_size,
                      heightmap=app.heightmap,
                      max_height=float(app.params.max_height))
    prepass = r.cached_horizon_prepass(app.params)
    lum, chain = 0.5, []
    for i in range(APP_FRAMES):
        _, lum = r.render_adaptive(cams.frame(i), app.params, lum, APP_DT,
                                   shadow_prepass=prepass)
        chain.append(lum)
    chain = torch.stack(chain).cpu().numpy()
    rel = float(np.max(np.abs(chain - hist) / np.abs(hist)))
    if not np.allclose(hist, chain, rtol=1e-6, atol=0.0):
        raise RuntimeError(f"adapt_history differs from the hand-threaded "
                           f"chain by {rel} (relative)")
    log(f"app run 2 (adapting): {stats2}; adapt_history "
        f"{hist[0]:.6f} -> {hist[-1]:.6f}, equal to the hand-threaded "
        f"render_adaptive chain (max rel diff {rel:.3g}); launches "
        f"{launched}; frame ms ({card}, host wall) mean "
        f"{np.mean(ms2):.3f} p50 {np.median(ms2):.3f} max {np.max(ms2):.3f}, "
        f"Wait GPU share {wait2:.4f}; {time.perf_counter() - t1:.1f} s")

    # run 3: no adaptation, bit-identical to Renderer.render
    t1 = time.perf_counter()
    outs, launched, sec, ms3, wait3 = app_run(app, "app run 3",
                                              num_frames=APP_FRAMES,
                                              adapt=False)
    if launched != launches(raster=APP_FRAMES):
        raise RuntimeError(f"app run 3 launches {launched}")
    for i, o in enumerate(outs):
        ref = r.render(cams.frame(i), app.params, shadow_prepass=prepass)
        for f in ("ldr", "depth", "prim_id", "overflow_mask"):
            if not torch.equal(getattr(o, f), getattr(ref, f)):
                raise RuntimeError(f"app run 3 frame {i}: {f} differs from "
                                   f"Renderer.render")
    stats3 = frame_stats(outs, "app run 3")
    del outs
    log(f"app run 3 (adapt=False): {stats3}; each bit-identical to "
        f"Renderer.render (ldr, depth, prim_id, overflow_mask); launches "
        f"{launched}; frame ms ({card}, host wall) mean {np.mean(ms3):.3f} "
        f"p50 {np.median(ms3):.3f} max {np.max(ms3):.3f}, Wait GPU share "
        f"{wait3:.4f}; {time.perf_counter() - t1:.1f} s")

    # per-pass times, horizon and map mode (phase 10's budgets)
    t1 = time.perf_counter()
    passes = {"horizon": dict(app.profile_passes(cams.frame(JSON_CAMERA))
                              .results)}
    cfg_map = FrameConfig(width=WIDTH, height=HEIGHT,
                          terrain=TerrainSettings(max_instances=1024),
                          shadow_mode="map", shadow_resolution=SHADOW_RES)
    app_map = App(cfg_map, scene=Scene.default(device), device=device)
    app_map.renderer = Renderer(cfg_map, app_map.heightmap, app_map.albedo,
                                max_work=MAX_WORK, max_active=MAP_MAX_ACTIVE,
                                scene=Scene.default(device), device=device)
    passes["map"] = dict(app_map.profile_passes(cams.frame(JSON_CAMERA))
                         .results)
    del app_map
    common = {"TerrainPass::UpdateTransforms", "Scene Refresh",
              "GBuffer fill", "Terrain", "Deferred Lighting", "ToneMapping",
              "Sky", "GPU Frame"}
    for mode, extra in (("horizon", {"Terrain Shadow"}),
                        ("map", {"ShadowMap", "Cascade ShadowMap"})):
        if set(passes[mode]) != common | extra or not all(
                v > 0 for v in passes[mode].values()):
            raise RuntimeError(f"{mode} passes {passes[mode]}")
    print(json.dumps({"passes": passes, "camera": JSON_CAMERA,
                      "device": card}))
    log(f"app passes (camera {JSON_CAMERA}, median of 10 calls, CUDA "
        f"events): {time.perf_counter() - t1:.1f} s")

    t1 = time.perf_counter()
    trace = device_trace(app, cams, prepass)
    log(f"app device trace (camera {TRACE_CAMERAS}, {card}): "
        f"{trace['kernels_per_frame']:.0f} kernels and "
        f"{trace['copies_sets_per_frame']:.0f} copies/sets a frame, device "
        f"busy {trace['busy_ms_per_frame']:.3f} ms a frame, "
        f"{trace['busy_share']:.4f} of the frame's CUDA-event time "
        f"({np.mean(trace['frame_ms']):.3f} ms; "
        f"{trace['busy_share_traced']:.4f} of "
        f"{np.mean(trace['frame_ms_traced']):.3f} ms under the profiler); "
        f"top kernels (ms a frame): "
        + "; ".join(f"{k} {v:.4f}" for k, v in
                    trace["top_kernels_ms_per_frame"])
        + f"; {time.perf_counter() - t1:.1f} s")
    del app

    # the native heightmap path, built at first use
    t1 = time.perf_counter()
    app_1k = App(cfg, heightmap_resolution=1024, scene=Scene.default(device),
                 device=device)
    outs, launched, _, _, _ = app_run(app_1k, "app 1024", num_frames=2)
    log(f"app on the 1024x1024 native heightmap: "
        f"{frame_stats(outs, 'app 1024')}; launches {launched}; "
        f"{time.perf_counter() - t1:.1f} s (whole app phase "
        f"{time.perf_counter() - t0:.1f} s)")


def phase_editor(device, card: str) -> tuple:
    """Phase 13 (module docstring). Returns the JSON numbers of B1 (at the
    editor cameras and on the mesh-top field's triangles) and of B2 (the
    shadow-depth light pass), and the path's launches."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        return _phase_editor(device, card, tmp)


def _phase_editor(device, card: str, tmp: str) -> tuple:
    import torch

    from vrenderer_tpu_torch.app import App
    from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings
    from vrenderer_tpu_torch.editor import Editor
    from vrenderer_tpu_torch.models.scene import load_gltf
    from vrenderer_tpu_torch.ops import shadow
    from vrenderer_tpu_torch.renderer import Renderer

    t0 = time.perf_counter()
    glb = f"{tmp}/scene.glb"
    write_scene_glb(glb)
    cfg = FrameConfig(width=WIDTH, height=HEIGHT,
                      terrain=TerrainSettings(max_instances=1024))
    tpb = cfg.terrain.tris_per_instance
    t1 = time.perf_counter()
    sc = load_gltf(glb, device=device)
    load_s = time.perf_counter() - t1
    tris = [i.mesh.num_tris for i in sc.instances]
    blocks = sum(-(-t // tpb) for t in tris)
    log(f"editor scene: {len(tris)} instances "
        f"({', '.join(f'{i.name} {t}' for i, t in zip(sc.instances, tris))} "
        f"triangles), {sum(tris)} triangles, {blocks} scene blocks of {tpb}; "
        f"load_gltf {load_s:.2f} s")
    del sc

    ed = Editor(App(cfg, device=device), out_dir=f"{tmp}/editor")
    frame_spans = []
    render_frame = ed._render

    def timed_render():
        """The editor's frame (render and the ldr copy) between CUDA
        events, without the render command's PNG write."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = render_frame()
        end.record()
        frame_spans.append((start, end))
        return out

    ed._render = timed_render
    reset_launches()
    frames, ms, b1_expect, b2_expect = [], [], 0, 0
    lock_state = reload_pair = None
    for line in EDITOR_SCRIPT:
        cmd = line.format(glb=glb, tmp=tmp)
        r = ed.app.renderer
        scene = r.scene_transforms is not None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        resp = ed.execute(cmd)
        end.record()
        if resp.startswith(("error", "unknown")):
            raise RuntimeError(f"editor: {cmd!r} -> {resp}")
        if cmd == "render":
            out = ed.last_output
            frames.append((len(frames), ed.camera, out))
            ms.append((start, end))
            b1_expect += 1 + scene     # the main raster and the mesh-top field
            if ed.locked_instances is not None:
                lock_state = (r, ed.camera, ed.app.params,
                              ed.locked_instances, out,
                              r.scene_transforms.clone())
        elif cmd.startswith("fly"):
            b1_expect += int(cmd.split()[1]) + scene    # + its prepass cache
        elif cmd.startswith("shadow-depth"):
            b2_expect += 1
        elif cmd == "reload":
            reload_pair = frames[-1][2]
        elif cmd.startswith("step"):
            walk_cam = ed.camera
        log(f"editor> {cmd}: {resp.splitlines()[0]}")
    torch.cuda.synchronize()
    launched = read_launches()
    run_s = time.perf_counter() - t0

    if launched != launches(raster=b1_expect, raster_depth=b2_expect):
        raise RuntimeError(f"editor launches {launched}, expected B1 "
                           f"{b1_expect}, B2 {b2_expect}")
    for i, _, out in frames:
        fin = bool(torch.isfinite(out.ldr).all() & torch.isfinite(out.hdr)
                   .all())
        cov = float((out.prim_id >= 0).float().mean())
        if not (fin and 0.0 < cov < 1.0 and int(out.overflow_mask) == 0):
            raise RuntimeError(
                f"editor frame {i}: finite {fin}, coverage {cov}, overflow "
                f"mask {int(out.overflow_mask)}, work items "
                f"{int(out.num_work_items)} (max_work "
                f"{ed.app.renderer.max_work}), instances "
                f"{int(out.num_selected)}")
    work = [int(o.num_work_items) for _, _, o in frames]
    scene_px = [int((o.prim_id >= 1024 * tpb).sum()) for _, _, o in frames]
    after = frames[-2][2]
    if not all(torch.equal(getattr(reload_pair, f), getattr(after, f))
               for f in ("ldr", "hdr", "depth", "prim_id", "overflow_mask")):
        raise RuntimeError("the frame after reload differs from the one "
                           "before it")
    r_lock, cam, params, inst, out, xf = lock_state
    r_lock.scene_transforms = xf
    ref = r_lock.render_locked(cam, params, inst)
    if not all(torch.equal(getattr(ref, f), getattr(out, f))
               for f in ("ldr", "depth", "prim_id", "overflow_mask")):
        raise RuntimeError("the lock frame differs from render_locked with "
                           "select's instances")
    walk_items = [int(rw.raster_inputs(walk_cam, ed.app.params)[1].num_items)
                  for rw in (r_lock, Renderer(cfg, ed.app.heightmap,
                                              ed.app.albedo, device=device))]
    log(f"editor walk camera (eye {walk_cam.eye.cpu().numpy().round(2)}, "
        f"not rendered): work items {walk_items[0]} with the scene, "
        f"{walk_items[1]} for the terrain alone, max_work "
        f"{ed.app.renderer.max_work}")
    times = [s.elapsed_time(e) for s, e in frame_spans]
    cmd_times = [s.elapsed_time(e) for s, e in ms]
    log(f"editor path ({len(frames)} renders + fly 8, {WIDTH}x{HEIGHT}): "
        f"every response ok, frames finite, covered in (0, 1), overflow "
        f"mask 0; work items {work} of max_work {ed.app.renderer.max_work}; scene "
        f"pixels {scene_px}; launches {launched} = B1 {len(frames) + 8} "
        f"frames + {b1_expect - len(frames) - 8} mesh-top fields, B2 "
        f"{b2_expect} shadow-depth; reload frame bit-identical; lock frame "
        f"equal to render_locked; {run_s:.1f} s")
    log(f"editor frame times ({card}, CUDA events around Editor._render: "
        f"the frame, its host work and the ldr copy): mean "
        f"{np.mean(times):.3f} ms, p50 {np.median(times):.3f} ms, max "
        f"{np.max(times):.3f} ms over {len(times)} renders; the render "
        f"command with its PNG write: mean {np.mean(cmd_times):.3f} ms, p50 "
        f"{np.median(cmd_times):.3f} ms, max {np.max(cmd_times):.3f} ms")

    # the kernels at this path's own inputs (launches here are not counted)
    r = r_lock
    params = ed.app.params
    cams = [frames[i][1] for i in EDITOR_KERNEL_FRAMES]
    b1 = {f"frame {i}": b1_vs_plain(
        f"(editor path) frame {i}", *r.raster_inputs(c, params), WIDTH,
        HEIGHT, cfg.raster.tile_w, layouts=False)
        for i, c in zip(EDITOR_KERNEL_FRAMES, cams)}
    top = r._scene_top_world(r.scene_transforms)
    res = r.heightmap.shape[0]
    b1["mesh_top"] = b1_vs_plain(
        f"(editor mesh-top field, {top.shape[1] // 3} compact triangles in "
        f"one instance)", *shadow.mesh_top_inputs(
            top, torch.ones((1,), dtype=torch.bool, device=device),
            float(cfg.terrain.world_size), res), res, res, cfg.raster.tile_w,
        layouts=False)
    b2 = b2_vs_plain("(editor shadow-depth light pass)",
                     *r.light_raster_inputs(None, params),
                     cfg.shadow_resolution, cfg.raster.tile_w,
                     layouts=False)

    # the two backends on the card, at a small frame with the same scene
    small = FrameConfig(width=BACKEND_SIZE[0], height=BACKEND_SIZE[1],
                        terrain=TerrainSettings(max_instances=1024))
    t1 = time.perf_counter()
    outs = {}
    for backend in ("xla", "pallas"):
        rb = Renderer(small, ed.app.heightmap, ed.app.albedo,
                      raster_backend=backend,
                      scene=load_gltf(glb, device=device), device=device)
        vc = rb._view(cams[0])
        outs[backend] = rb._terrain_pass(vc, params,
                                         rb._shadow_inputs(vc, params))
    (zx, idx, atx, _, nx), (zp, idp, atp, _, npw) = (outs["xla"],
                                                      outs["pallas"])
    cov = idx >= 0
    dz = float((zx - zp)[cov].abs().max())
    da = float((atx - atp)[cov].abs().max())
    if not (torch.equal(idx, idp) and dz <= 1e-6 and da <= 3e-4
            and int(nx) == 0 < int(npw)):
        raise RuntimeError(f"xla vs pallas backends: ids equal "
                           f"{torch.equal(idx, idp)}, depth {dz}, attrs {da}")
    log(f"backends at {BACKEND_SIZE[0]}x{BACKEND_SIZE[1]} (frame 0's camera, "
        f"the loaded scene): xla (dense oracle) and pallas (B1) ids equal, "
        f"depth max diff {dz:.3g}, attrs {da:.3g}, covered "
        f"{float(cov.float().mean()):.4f}, work items xla {int(nx)} / "
        f"pallas {int(npw)}; {time.perf_counter() - t1:.1f} s (whole editor "
        f"phase {time.perf_counter() - t0:.1f} s)")
    return b1, b2, launched


def sub_cameras(cams, idx):
    """The flythrough cameras ``idx`` as one stacked Camera."""
    from vrenderer_tpu_torch.camera import Camera

    return Camera(*(v[list(idx)] for v in cams))


def sharded_run(name: str, r, params, cams, mesh, **kw):
    """``render_frames_sharded`` over ``mesh`` with the kernel launches
    counted from 0 and CUDA events around the call: every frame finite, no
    band overflowing. Returns (frames, overflow, adapted, ms a frame,
    launches)."""
    import torch

    from vrenderer_tpu_torch.parallel import sharded

    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    frames, ovf, adapted = sharded.render_frames_sharded(
        r, cams, params, mesh, return_aux=True, **kw)
    end.record()
    torch.cuda.synchronize()
    launched = read_launches()
    n = frames.shape[0]
    ms = start.elapsed_time(end) / n
    fin = bool(torch.isfinite(frames).all())
    if not fin or bool(ovf.any()):
        raise RuntimeError(f"sharded {name}: finite {fin}, overflow "
                           f"{ovf.tolist()}")
    log(f"sharded {name}: mesh {mesh.shape}, {n} frames of "
        f"{tuple(frames.shape[1:])} finite, no band overflowing; "
        f"{ms:.3f} ms a frame (CUDA events); launches {launched}")
    return frames, ovf, adapted, ms, launched


def single_frames(r, params, cams, idx, adapt=False):
    """``Renderer.render`` (or, with ``adapt``, a ``render_adaptive``
    chain from 0.5 over ``idx``) at each camera of ``idx``: (outputs,
    adapted luminances, ms a frame from CUDA events)."""
    import torch

    outs, lums = [], []
    lum = torch.tensor(0.5, device=r.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in idx:
        if adapt:
            out, lum = r.render_adaptive(cams.frame(i), params, lum,
                                         SHARD_DT)
            lums.append(lum)
        else:
            out = r.render(cams.frame(i), params)
        outs.append(out)
    end.record()
    torch.cuda.synchronize()
    return outs, lums, start.elapsed_time(end) / len(idx)


def band_share(name: str, frames, singles) -> float:
    """The largest share, over the frames, of pixels whose channels differ
    from the single frame's by more than SHARD_PIXEL_TOL; raises at
    SHARD_PIXEL_SHARE or above."""
    shares = [float(((f - s.ldr).abs().amax(-1) > SHARD_PIXEL_TOL)
                    .float().mean()) for f, s in zip(frames, singles)]
    if not max(shares) < SHARD_PIXEL_SHARE:
        raise RuntimeError(f"sharded {name}: pixel shares {shares} over "
                           f"{SHARD_PIXEL_TOL} (bound {SHARD_PIXEL_SHARE})")
    return max(shares)


def phase_sharded(device, card: str, params, cams) -> dict:
    """Phase 14: the sharded screen-band path at 1920x1152 (the bench
    renderer, horizon mode, boot cube, no prepass, as the JAX package's
    sharded path takes none). (a) the card's own (1, 1) mesh: frames and
    overflow bit-identical to ``Renderer.render``. (b) three bands on one
    card, (frame 2, tile 3), eye adaptation on: frames within the band
    bound of a ``render_adaptive`` chain per 3-frame chunk, the adapted
    columns equal across bands and within SHARD_LUM_RTOL of the chain.
    (c) map mode, (1, 3): frames within the band bound, B2 once a band.
    (d) ``two_phase``, (1, 3): frames bit-identical to the single-phase
    banded frames. Each run's launches are counted from 0 and checked.
    (e) B1, B3a, the filter, B3b at band 1 of 3 and B2 at the map path's
    light pass (the same in every band), against their plain versions.
    Returns the ``sharded`` JSON numbers and the kernels' (e) numbers."""
    import torch

    from vrenderer_tpu_torch.config import RasterSettings
    from vrenderer_tpu_torch.parallel import sharded

    t0 = time.perf_counter()
    r, _, _ = bench_renderer(device)
    W, tile = WIDTH, r.config.raster.tile_w
    band_h = HEIGHT // SHARD_BANDS
    mesh3 = sharded.make_mesh([device] * SHARD_BANDS)
    runs, shares, ms = {}, {}, {}

    # (a) the card's own mesh: bit-identical to Renderer.render
    mesh1 = sharded.make_mesh(n_devices=1)
    idx = SHARD_CAMERAS
    # warm-up (allocator, libraries) outside the counted and timed runs
    sharded.render_frames_sharded(r, sub_cameras(cams, idx[:1]), params,
                                  mesh1)
    r.render(cams.frame(idx[0]), params)
    frames, ovf, _, ms["mesh_1x1"], runs["a"] = sharded_run(
        "(a) own mesh", r, params, sub_cameras(cams, idx), mesh1)
    if runs["a"] != launches(raster=2 * len(idx)):
        raise RuntimeError(f"sharded (a) launches {runs['a']}")
    singles, _, ms["single"] = single_frames(r, params, cams, idx)
    for k, (f, o, s) in enumerate(zip(frames, ovf, singles)):
        if not (torch.equal(f, s.ldr) and bool(o[0]) == bool(s.overflow)):
            raise RuntimeError(f"sharded (a) camera {idx[k]}: differs from "
                               f"Renderer.render")
    log(f"sharded (a): {len(idx)} frames over {mesh1.shape} bit-identical "
        f"to Renderer.render (ldr, overflow)")

    # (b) three bands on one card, two frame rows, adaptation on
    idx = SHARD_ADAPT_CAMERAS
    mesh23 = sharded.make_mesh([device] * 6, frame_axis=2)
    frames, _, adapted, ms["mesh_2x3_adapt"], runs["b"] = sharded_run(
        "(b) adapting", r, params, sub_cameras(cams, idx), mesh23,
        adapted_lum=0.5, dt=SHARD_DT)
    if runs["b"] != launches(raster=2 * len(idx) * SHARD_BANDS):
        raise RuntimeError(f"sharded (b) launches {runs['b']}")
    half = len(idx) // 2
    chain, lums = [], []
    for part in (idx[:half], idx[half:]):
        outs, ls, _ = single_frames(r, params, cams, part, adapt=True)
        chain += outs
        lums += ls
    shares["b"] = band_share("(b)", frames, chain)
    lum = torch.stack(lums)
    if not torch.equal(adapted, adapted[:, :1].expand_as(adapted)):
        raise RuntimeError("sharded (b): bands disagree on the adapted "
                           "luminance")
    lum_err = float(((adapted[:, 0] - lum).abs() / lum).max())
    if not lum_err <= SHARD_LUM_RTOL:
        raise RuntimeError(f"sharded (b): adapted luminance off the chain by "
                           f"{lum_err} (relative)")
    log(f"sharded (b): frames within the band bound of the render_adaptive "
        f"chains (worst pixel share {shares['b']:.3g}), adapted columns "
        f"equal, {adapted[:, 0].tolist()} vs chain {lum.tolist()} "
        f"(relative error {lum_err:.3g})")

    # (c) map mode
    idx = SHARD_FEW_CAMERAS
    few = sub_cameras(cams, idx)
    n = len(idx) * SHARD_BANDS
    rm, _, _ = bench_renderer(device, max_active=MAP_MAX_ACTIVE,
                              shadow_mode="map", shadow_resolution=SHADOW_RES)
    frames, _, _, ms["map_mesh_1x3"], runs["c"] = sharded_run(
        "(c) map", rm, params, few, mesh3)
    if runs["c"] != launches(raster=n, raster_depth=n):
        raise RuntimeError(f"sharded (c) launches {runs['c']}")
    singles, _, ms["map_single"] = single_frames(rm, params, cams, idx)
    shares["c"] = band_share("(c)", frames, singles)
    log(f"sharded (c): map frames within the band bound of the single "
        f"frames (worst pixel share {shares['c']:.3g})")

    # (d) two_phase against the single-phase banded frames, same mesh
    one, _, _, ms["mesh_1x3"], _ = sharded_run("(d) single-phase", r, params,
                                               few, mesh3)
    singles, _, _ = single_frames(r, params, cams, idx)
    shares["d_single_phase"] = band_share("(d) single-phase", one, singles)
    r2, _, _ = bench_renderer(device, raster=RasterSettings(two_phase=True))
    two, _, _, ms["mesh_1x3_two_phase"], runs["d"] = sharded_run(
        "(d) two-phase", r2, params, few, mesh3)
    if runs["d"] != launches(raster=n, raster_zid=n, raster_filter=n,
                             raster_resolve=n):
        raise RuntimeError(f"sharded (d) launches {runs['d']}")
    if not torch.equal(two, one):
        raise RuntimeError("sharded (d): two-phase banded frames differ from "
                           "the single-phase banded frames")
    log("sharded (d): two-phase banded frames bit-identical to the "
        "single-phase banded frames, which are within the band bound of "
        f"the single frames (worst pixel share {shares['d_single_phase']:.3g})")

    # (e) the kernels against their plain versions on banded inputs
    cam = cams.frame(JSON_CAMERA)
    band = (band_h, band_h)                      # band 1 of 3
    label = f"camera {JSON_CAMERA} band 1 of 3"
    packed, work = r.raster_inputs(cam, params, band=band)
    rs = r.config.raster
    kern = {"raster": b1_vs_plain(f"(sharded horizon path) {label}", packed,
                                  work, W, band_h, tile, layouts=False)}
    kern["raster_zid"], kern["raster_resolve"] = two_phase_vs_plain(
        f"(sharded horizon path) {label}", packed, work, W, band_h, tile,
        dict(sub_h=rs.subtile_h, win_w=rs.win_w))
    kern["raster_map"] = b1_vs_plain(
        f"(sharded map path) {label}",
        *rm.raster_inputs(cam, params, band=band), W, band_h, tile,
        layouts=False)
    kern["raster_depth"] = b2_vs_plain(
        f"(sharded map path, every band's light pass) camera {JSON_CAMERA}",
        *rm.light_raster_inputs(cam, params), SHADOW_RES, tile,
        layouts=False)
    del r, r2, rm, packed, work

    total = Counter()
    for run in runs.values():
        total.update(run)
    log(f"sharded frame times ({card}): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in ms.items())
        + f" a frame (CUDA events, 1920x1152; phase "
        f"{time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"sharded": {
        "meshes": {"a": [1, 1], "b": [2, SHARD_BANDS],
                   "c": [1, SHARD_BANDS], "d": [1, SHARD_BANDS]},
        "frames": {"a": len(SHARD_CAMERAS), "b": len(SHARD_ADAPT_CAMERAS),
                   "c": len(SHARD_FEW_CAMERAS), "d": len(SHARD_FEW_CAMERAS)},
        "max_pixel_share": shares, "pixel_share_bound": SHARD_PIXEL_SHARE,
        "adapted_rel_err": lum_err, "launches": runs, "ms": ms,
        "card": card}}), flush=True)
    return dict(total), kern


def expected_counts(stored: dict, name: str, mode: str, r) -> dict:
    """The JAX package's counts of variant ``name`` (op by op, stored in
    tests/workload_counts_jax.npz) as the port's frames report them: the
    selection count (``map`` shares the light pass's geometry and reports
    the light selection's), the work items and the overflow mask each
    camera must carry."""
    from vrenderer_tpu_torch import workloads

    g = {k: stored[f"{name}:{k}"] for k in ("selected", "light_selected",
                                            "work", "light_work")}
    sel = g["light_selected"] if mode == "map" else g["selected"]
    mask = (g["work"] > r.max_work) + 2 * (sel > r.max_active)
    if mode in workloads.MAP_MODES:
        mask = mask + 4 * ((g["light_work"] > r.max_work)
                           | (g["light_selected"] > r.max_active))
    return {"selected": sel, "work": g["work"], "mask": mask,
            "light_work": g["light_work"]}


def workload_run(name: str, mode: str, quant, shadow_res, device,
                 stored: dict, card: str) -> dict:
    """One variant of phase 15 (module docstring): probe, the steady loop
    of all cameras checked against the stored JAX counts, cached frames
    against inline ones, and the per-camera statistics. Returns its JSON
    numbers and what the kernel checks need."""
    import torch

    from vrenderer_tpu_torch import workloads

    t0 = time.perf_counter()
    r, params, cams = workloads.build(mode, device, quant, shadow_res)
    cfg = r.config
    n = workloads.N_CAMERAS
    out0 = workloads.probe(r, params, cams, mode)      # also the warm-up
    probe = {"instances": int(out0.num_instances),
             "work_items": int(out0.num_work_items)}
    quant_mode = mode in workloads.QUANT_MODES
    crossings = (workloads.cell_crossings(cams, cfg.shadow_eye_quant)
                 if quant_mode else None)
    # the frames held to inline ones: those of a cached loop (horizon
    # prepass, quantized-eye map), the first after a crossing among them
    check = []
    if quant_mode or mode not in workloads.MAP_MODES:
        check = [0, n - 1]
    if quant_mode:
        check.insert(1, workloads.crossing_frames(
            cams, cfg.shadow_eye_quant)[0])
    reset_launches()
    steady = workloads.steady_frames(r, params, cams, mode, keep=check)
    torch.cuda.synchronize()
    launched = read_launches()

    col = {k: j for j, k in enumerate(workloads.SUMMARY)}
    s = steady.summary
    exp = expected_counts(stored, name, mode, r)
    cov = s[:, col["coverage"]]
    cov_ok = (cov > 0) & ((cov <= 1) if name in WORKLOAD_FULL_COVER
                          else (cov < 1))
    bad = {
        "not finite": np.nonzero(s[:, col["finite"]] != 1)[0],
        "coverage": np.nonzero(~cov_ok)[0],
        "selection differs from JAX": np.nonzero(
            s[:, col["num_selected"]] != exp["selected"])[0],
        "overflow mask differs from JAX's": np.nonzero(
            s[:, col["overflow_mask"]] != exp["mask"])[0],
        "work items differ from JAX": np.nonzero(
            s[:, col["num_work_items"]] != exp["work"])[0],
    }
    bad = {k: v.tolist() for k, v in bad.items() if v.size}
    if bad:
        raise RuntimeError(f"workload {name}: " + "; ".join(
            f"{k} at cameras {v}" for k, v in bad.items()))
    b2 = {"map": n, "mapref": n}.get(mode, 0)
    if quant_mode:
        b2 = crossings + 1
    want = launches(raster=n + (0 if mode in workloads.MAP_MODES else 1),
                    raster_depth=b2)
    if launched != want or steady.light_rasters != b2:
        raise RuntimeError(f"workload {name}: launches {launched}, light "
                           f"rasters {steady.light_rasters}, expected {want}")
    for i in check:
        inline = r.render(cams.frame(i), params)
        for f in ("ldr", "hdr", "depth", "prim_id", "overflow_mask"):
            if not torch.equal(getattr(steady.frames[i], f),
                               getattr(inline, f)):
                raise RuntimeError(f"workload {name}: cached frame {i}: {f} "
                                   f"differs from the inline frame")
    loop_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    stats = workloads.camera_stats(r, params, cams, mode, steady)
    rows = stats["cameras"]
    heavy = max(rows, key=lambda row: row["evaluated_pairs"])["camera"]
    over = np.nonzero(exp["mask"])[0].tolist()
    log(f"workload {name} ({cfg.width}x{cfg.height}, {cfg.shadow_mode}, "
        f"max_active {r.max_active}, max_work {r.max_work}): probe camera 0 "
        f"{probe['instances']} instances, {probe['work_items']} work items; "
        f"{n} frames finite, coverage {cov.min():.4f}-{cov.max():.4f}, "
        f"selection and work items equal to JAX's at every camera "
        f"(selected {int(s[:, col['num_selected']].min())}-"
        f"{int(s[:, col['num_selected']].max())}, work items "
        f"{int(s[:, col['num_work_items']].min())}-"
        f"{int(s[:, col['num_work_items']].max())}), overflow "
        + (f"at cameras {over} as in the JAX package" if over else "none")
        + f"; light rasters {steady.light_rasters}"
        + (f" = {crossings} crossings + 1" if quant_mode else "")
        + f"; launches {launched}; cached frames {check} bit-identical to "
        f"inline; loop {loop_s:.1f} s, stats "
        f"{time.perf_counter() - t1:.1f} s")
    log(f"workload {name} frame times ({card}, CUDA events, {n} cameras): "
        f"mean {stats['mean_ms']:.3f} ms, p50 {stats['p50_ms']:.3f}, max "
        f"{stats['max_ms']:.3f}; slowest "
        + ", ".join(f"cam {i} {m:.3f}" for i, m in stats["slowest"])
        + "; corr(ms, x): " + ", ".join(
            f"{k} " + ("n/a" if v is None else f"{v:+.3f}")
            for k, v in stats["corr"].items())
        + f"; evaluated pairs {min(r_['evaluated_pairs'] for r_ in rows)}-"
        f"{max(r_['evaluated_pairs'] for r_ in rows)} (camera {heavy} the "
        f"most)")
    light_cam = int(np.argmax(exp["light_work"]))
    return {"r": r, "params": params, "cams": cams, "heavy": heavy,
            "light_camera": light_cam, "launches": launched, "json": {
                "mode": mode, "size": [cfg.width, cfg.height],
                "shadow": cfg.shadow_mode,
                "shadow_resolution": cfg.shadow_resolution,
                "quant": cfg.shadow_eye_quant, "max_active": r.max_active,
                "max_work": r.max_work, "probe": probe,
                "light_rasters": steady.light_rasters,
                "cell_crossings": crossings, "overflow_cameras": over,
                "coverage": [float(cov.min()), float(cov.max())],
                "launches": launched,
                **{k: stats[k] for k in ("mean_ms", "p50_ms", "max_ms",
                                         "slowest", "corr")},
                "work_items": [int(s[:, col["num_work_items"]].min()),
                               int(s[:, col["num_work_items"]].max())],
                "evaluated_pairs": [min(r_["evaluated_pairs"] for r_ in rows),
                                    max(r_["evaluated_pairs"]
                                        for r_ in rows)],
                "heaviest_camera": heavy, "card": card}}


def einsum_separable(tex, u, v, mode: str = "lattice"):
    """The grid sampler's earlier form, the JAX package's: two float32
    matrix products with ``interp_matrix`` weights. Returns (rows, samples)."""
    import torch

    from vrenderer_tpu_torch.ops import texture

    H, W = tex.shape[0], tex.shape[1]
    au = texture.interp_matrix(u, W, mode)
    av = texture.interp_matrix(v, H, mode)
    if tex.ndim == 2:
        rows = torch.einsum("...vh,hw->...vw", av, tex)
        return rows, torch.einsum("...vw,...uw->...vu", rows, au)
    rows = torch.einsum("...vh,hwc->...vwc", av, tex)
    return rows, torch.einsum("...vwc,...uw->...vuc", rows, au)


def bits_differ(a, b) -> int:
    """How many elements of ``a`` (any device) and ``b`` differ in their
    bits (floats compared as integers, so -0.0 differs from +0.0)."""
    import torch

    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        raise RuntimeError(f"{tuple(a.shape)} {a.dtype} against "
                           f"{tuple(b.shape)} {b.dtype}")
    if a.dtype.is_floating_point:
        as_int = {torch.float32: torch.int32, torch.float64: torch.int64}
        a, b = a.view(as_int[a.dtype]), b.view(as_int[b.dtype])
    return int((a != b).sum())


def _to(x, device):
    """Tensors, and the tensors of a NamedTuple or dict, moved to
    ``device``."""
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, tuple):
        moved = (_to(f, device) for f in x)
        return type(x)(*moved) if hasattr(x, "_fields") else tuple(moved)
    return x.to(device)


def vertex_steps(ts, x) -> dict:
    """The vertex stage's operations one by one, as ops/vertex.py orders
    them, from the inputs ``x`` (VERTEX_MODE's): {step: tensor}. Each step
    reads earlier steps' values from the dict it fills, so it runs from
    another device's values too (``step_diffs``)."""
    import torch

    from vrenderer_tpu_torch.ops import texture, vertex
    from vrenderer_tpu_torch.utils import math3d

    S, world = ts.verts_per_side, float(ts.world_size)
    gs = float(ts.grid_size)
    I = x["inst"].position.shape[0]
    steps = [
        ("g", lambda e: math3d.linspace(-1.0, 1.0, S,
                                        device=e["hm"].device)),
        ("ux", lambda e: e["inst"].position[:, 0:1]
         + e["inst"].extents[:, 0:1] * e["g"][None]),
        ("uz", lambda e: e["inst"].position[:, 2:3]
         + e["inst"].extents[:, 2:3] * e["g"][None]),
        ("u", lambda e: texture.world_to_uv(e["ux"], world)),
        ("v", lambda e: texture.world_to_uv(e["uz"], world)),
        ("h", lambda e: texture.sample_separable(e["hm"], e["u"], e["v"],
                                                 mode=ts.uv_mode)),
        ("dx2", lambda e: (e["ux"][:, None, :].expand(I, S, S)
                           - e["eye"][0]) ** 2),
        ("dz2", lambda e: (e["uz"][:, :, None].expand(I, S, S)
                           - e["eye"][2]) ** 2),
        ("d2", lambda e: e["dx2"] + e["dz2"]),
        ("dist", lambda e: math3d.sqrt_rn(e["d2"])),
        ("ge", lambda e: 2.0 * e["inst"].extents[:, 0]),
        ("lod", lambda e: torch.clamp(torch.floor(torch.log2(torch.clamp(
            e["ge"], min=1e-20))), 0, e["lr"].shape[0] - 1).long()),
        ("rng", lambda e: e["lr"][e["lod"]][:, None, None]),
        ("start", lambda e: e["rng"] * 0.85),
        ("num", lambda e: e["dist"] - e["start"]),
        ("den", lambda e: e["rng"] - e["start"]),
        ("ratio", lambda e: e["num"] / e["den"]),
        ("k", lambda e: torch.clamp(e["ratio"], 0.0, 1.0)),
        ("frac", lambda e: (((e["g"] + 1.0) * 0.5) * gs * 0.5 - torch.floor(
            ((e["g"] + 1.0) * 0.5) * gs * 0.5)) * 2.0 / gs),
        ("x_m", lambda e: e["ux"][:, None, :].expand(I, S, S)
         - e["frac"][None, None, :] * e["ge"][:, None, None] * e["k"]),
        ("z_m", lambda e: e["uz"][:, :, None].expand(I, S, S)
         - e["frac"][None, :, None] * e["ge"][:, None, None] * e["k"]),
        ("h_m", lambda e: vertex._blend_even(e["h"], e["k"])),
        ("y", lambda e: e["h_m"] * e["max_h"]),
        ("vis", lambda e: texture.sample_separable(torch.cat(
            [e["albedo"], e["nrm"], e["field"][..., None]], dim=-1),
            e["u"], e["v"], mode=ts.uv_mode)),
        ("alb_m", lambda e: vertex._blend_even(e["vis"][..., 0:3], e["k"])),
        ("nrm_m", lambda e: vertex._blend_even(e["vis"][..., 3:6], e["k"])),
        ("shad_m", lambda e: vertex._blend_even(e["vis"][..., 6], e["k"])),
        ("nrm_sq", lambda e: e["nrm_m"] * e["nrm_m"]),
        ("nrm_len2", lambda e: (e["nrm_sq"][..., 0:1] + e["nrm_sq"][..., 1:2])
         + e["nrm_sq"][..., 2:3]),
        ("nrm_unit", lambda e: e["nrm_m"] / math3d.sqrt_rn(e["nrm_len2"]
                                                          + 1e-20)),
    ]
    env = dict(x)
    for name, fn in steps:
        env[name] = fn(env)
    return env, steps


def step_diffs(ts, host: dict, device) -> dict:
    """Per step of ``vertex_steps``: (elements differing on the card from
    the CPU in the card's own chain, and in the step alone from the CPU's
    values)."""
    want, steps = vertex_steps(ts, host)
    chain, _ = vertex_steps(ts, _to(host, device))
    moved = _to(want, device)
    out = {}
    for name, fn in steps:
        out[name] = (bits_differ(chain[name], want[name]),
                     bits_differ(fn(moved), want[name]))
    return out


def vertex_stage_bits(device) -> dict:
    """Phase 15's vertex-stage check at VERTEX_MODE camera VERTEX_CAMERA
    (ROADMAP C). The CPU's inputs of the vertex stage (selection, eye,
    textures, shadow field), moved to the card, go through
    ``vertex_geometry`` and ``vertex_attrs``, setup and instance bboxes on
    both devices, and through the stage's operations one by one
    (``step_diffs``); each output is compared bit for bit, and so are the
    poses, LOD ranges, boot cube's transforms, mesh receivers'
    ``sample_points_matmul``, normal field and prepass of the card's own
    renderer, and the operations the stage used before (torch's float32
    sqrt, its sum of the normal's squares, the einsum sampler). Raises
    unless the stage's ``world`` and ``attrs``, the poses and the frame's
    work items (the card's renderer at its own camera) are equal on both
    devices. Returns {step: differing elements}."""
    import torch

    from vrenderer_tpu_torch import workloads
    from vrenderer_tpu_torch.ops import raster, raster_cuda, texture, vertex
    from vrenderer_tpu_torch.terrain import quadtree
    from vrenderer_tpu_torch.utils import math3d

    mode, i = VERTEX_MODE, VERTEX_CAMERA
    rc, params, cams = workloads.build(mode, "cpu")
    rg, params_g, _ = workloads.build(mode, device)
    cfg, ts = rc.config, rc.config.terrain
    cam = cams.frame(i)
    pre = workloads.frame_prepass(rc, params, cam.eye, mode)
    vc = rc._view(cam)
    sh = rc._shadow_inputs(vc, params, None, pre)
    lr = ts.lod_ranges()
    inst = rc._clip_active(quadtree.select_all_surfaces(
        ts, vc["camera_pos"], math3d.frustum_planes(vc["world_to_clip"]),
        lr))
    host = {"inst": inst, "eye": vc["camera_pos"], "wtc": vc["world_to_clip"],
            "hm": rc.heightmap, "albedo": rc.albedo, "field": sh.field,
            "nrm": rc._nrm_field, "max_h": params.max_height, "lr": lr,
            "tri": rc.tri_indices}

    def stage(x):
        geom = vertex.vertex_geometry(ts, x["inst"], x["eye"], x["hm"],
                                      x["max_h"], x["lr"])
        attrs = vertex.vertex_attrs(ts, geom, x["albedo"], x["field"],
                                    x["nrm"])
        comp = raster.setup_components(geom.world, attrs, x["inst"].valid,
                                       x["tri"], x["wtc"], cfg.width,
                                       cfg.height)
        bbox, usable, dist = raster_cuda.instance_bbox_components(
            comp, cfg.width, cfg.height, x["inst"].valid)
        return {"world": geom.world, "attrs": attrs,
                "clip": torch.stack(comp.vert_clip), "bbox": bbox,
                "usable": usable, "dist": dist}

    want = stage(host)
    card = stage(_to(host, device))
    diff = {k: bits_differ(card[k], want[k]) for k in want}
    steps = step_diffs(ts, host, device)
    env, _ = vertex_steps(ts, host)
    if (bits_differ(torch.stack([env["x_m"], env["y"], env["z_m"]], -1),
                    want["world"])
            or bits_differ(env["nrm_unit"], want["attrs"][..., 3:6])):
        raise RuntimeError("vertex_steps is out of step with ops/vertex.py")
    vis = torch.cat([host["albedo"], host["nrm"], host["field"][..., None]],
                    -1)
    # what the stage did before: torch's float32 sqrt and its sum over the
    # normal's squares, and the einsum form of the sampler (the JAX
    # package's), each alone from the CPU's values
    ug, vg = _to((env["u"], env["v"]), device)
    diff["dist, torch.sqrt"] = bits_differ(torch.sqrt(env["d2"].to(device)),
                                           torch.sqrt(env["d2"]))
    diff["nrm_len2, torch.sum"] = bits_differ(
        torch.sum(env["nrm_sq"].to(device), dim=-1, keepdim=True),
        torch.sum(env["nrm_sq"], dim=-1, keepdim=True))
    for name, tex in (("heights", host["hm"]), ("vis", vis)):
        rows, ein = einsum_separable(tex, env["u"], env["v"])
        rows_g, ein_g = einsum_separable(tex.to(device), ug, vg)
        diff[f"{name}, einsum rows"] = bits_differ(rows_g, rows)
        diff[f"{name}, einsum"] = bits_differ(ein_g, ein)
    # the poses, LOD ranges, boot cube's transforms, its receivers'
    # samples, normal field and prepass of the card's own renderer
    _, _, cams_g = workloads.build(mode, device)
    diff["cameras"] = sum(bits_differ(a, b) for a, b in zip(cams_g, cams))
    fly = workloads.cameras("1080p", rc.heightmap, ts.world_size)
    fly_g = workloads.cameras("1080p", rg.heightmap, ts.world_size)
    diff["flythrough cameras"] = sum(bits_differ(a, b)
                                     for a, b in zip(fly_g, fly))
    diff["lod ranges"] = bits_differ(ts.lod_ranges(device), lr)
    sw, sa = rc._scene_wa(params)
    sw_g, sa_g = rg._scene_wa(params_g)
    diff["scene world"] = bits_differ(sw_g, sw)
    diff["scene attrs"] = bits_differ(sa_g, sa)
    diff["scene top world"] = bits_differ(
        rg._scene_top_world(rg.scene_transforms),
        rc._scene_top_world(rc.scene_transforms))
    pts = torch.cat([sw[b, :3 * n] for b, n in
                     enumerate(rc._scene_block_nreal)])
    u = texture.world_to_uv(pts[:, 0], float(ts.world_size))
    v = texture.world_to_uv(pts[:, 2], float(ts.world_size))
    diff["receiver samples"] = bits_differ(texture.sample_points_matmul(
        *_to((pre[1], u, v), device)), texture.sample_points_matmul(
            pre[1], u, v))
    diff["normal field"] = bits_differ(rg._nrm_field, rc._nrm_field)
    pre_g = workloads.frame_prepass(rg, params_g, cam.eye.to(device), mode)
    diff["prepass field"] = bits_differ(pre_g[0], pre[0])
    diff["prepass line"] = bits_differ(pre_g[1], pre[1])
    items = int(rc.raster_inputs(cam, params, pre)[1].num_items)
    items_g = int(rg.raster_inputs(cams_g.frame(i), params_g,
                                   pre_g)[1].num_items)
    diff["work items"] = items_g - items
    log(f"vertex stage bits ({mode} camera {i}, card against CPU, elements "
        f"differing): " + ", ".join(f"{k} {v}" for k, v in diff.items())
        + f"; work items {items_g} (card), {items} (CPU); the stage's "
        f"operations (in the card's chain, alone): " + ", ".join(
            f"{k} {a}/{b}" for k, (a, b) in steps.items()))
    bad = [k for k in ("world", "attrs", "cameras", "flythrough cameras",
                       "work items") if diff[k]]
    if bad:
        raise RuntimeError(f"vertex stage at {mode} camera {i}: {bad} differ "
                           f"between the card and the CPU")
    return {**diff, "steps": steps}


def phase_workloads(device, card: str) -> tuple:
    """Phase 15 (module docstring). Returns the kernels' launches over the
    steady loops and their checks at these inputs."""
    from vrenderer_tpu_torch import workloads

    t0 = time.perf_counter()
    with np.load(REPO / "tests" / "workload_counts_jax.npz") as f:
        stored = {k: f[k] for k in f.files}
    total, runs, b1, b2, passes = Counter(), {}, {}, {}, None
    vbits = vertex_stage_bits(device)
    for name, mode, quant, res in WORKLOAD_VARIANTS:
        run = workload_run(name, mode, quant, res, device, stored, card)
        total.update(run["launches"])
        runs[name] = run["json"]
        r, params, cams = run["r"], run["params"], run["cams"]
        cfg = r.config
        # the kernels at these inputs (their launches here are not counted)
        if name in WORKLOAD_B1:
            i = run["heavy"]
            pre = workloads.frame_prepass(r, params, cams.eye[i], mode)
            b1[name] = {"camera": i, **b1_vs_plain(
                f"(workload {name}) camera {i}",
                *r.raster_inputs(cams.frame(i), params, pre), cfg.width,
                cfg.height, cfg.raster.tile_w, layouts=False)}
        if name in WORKLOAD_B2:
            i = run["light_camera"]
            res_l = cfg.shadow_resolution
            b2[name] = {"camera": i, **b2_vs_plain(
                f"(workload {name} light pass, {res_l}^2) camera {i}",
                *r.light_raster_inputs(cams.frame(i), params), res_l,
                cfg.raster.tile_w, layouts=False)}
        if name == "4k":
            t1 = time.perf_counter()
            passes = dict(workloads.pass_table(
                r, cams.frame(workloads.PASS_CAMERA)).results)
            log(f"workload 4k passes (camera {workloads.PASS_CAMERA}, median "
                f"of 10 calls, CUDA events, {card}): " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in passes.items())
                + f"; {time.perf_counter() - t1:.1f} s")
        del run, r
    secs = time.perf_counter() - t0
    print(json.dumps({"workloads": runs, "vertex_stage_bits": vbits,
                      "passes_4k": passes,
                      "pass_camera": workloads.PASS_CAMERA, "seconds": secs,
                      "device": card}), flush=True)
    log(f"workloads phase: {len(WORKLOAD_VARIANTS)} variants in {secs:.1f} s")
    return dict(total), b1, b2


# phase 16: the probes' kernels (vrenderer_tpu_torch/probes): the case each
# kernel's JSON entry reports, and the TPU kernels it replaces (file:line of
# the Pallas kernel function, then the others of its probes)
PROBE_KERNELS = {
    "probe_sweep": ("peak", "fma", "scripts/probe_peak.py:56",
                    ["scripts/probe_fma.py:29"]),
    "probe_eval": ("eval", "eval_edges", "scripts/probe_mosaic.py:43",
                   ["scripts/probe_pack2.py:48", "scripts/probe_pack2.py:66",
                    "scripts/probe_pack2.py:111", "scripts/probe_exact.py:48",
                    "scripts/probe_exact.py:72",
                    "scripts/probe_exact.py:91"]),
    "probe_merge": ("merge", "hotspot_packed64",
                    "scripts/probe_transposed.py:35",
                    ["scripts/probe_transposed.py:47"]),
    "probe_window": ("window", "coef_float4", "scripts/probe_window.py:55",
                     ["scripts/probe_window.py:73",
                      "scripts/probe_window.py:91"]),
}


def phase_probes(device, card: str) -> list:
    """Phase 16 (module docstring). Returns the probes' kernel entries."""
    import torch

    from vrenderer_tpu_torch.probes import eval as peval
    from vrenderer_tpu_torch.probes import merge, peak, window

    t0 = time.perf_counter()
    mods = {"peak": peak, "eval": peval, "merge": merge, "window": window}
    wrappers = {"peak": (peak.sweep, peak.ev_chain),
                "eval": (peval.evaluate,), "merge": (merge.merge,),
                "window": (window.window,)}
    for fns in wrappers.values():
        for fn in fns:
            fn.launches = 0
    res = {}
    for name, mod in mods.items():
        t1 = time.perf_counter()
        with torch.no_grad():
            res[name] = mod.run(device)
        torch.cuda.synchronize()
        log(f"probe {name} ({card}; each case equal to its plain version "
            f"bit for bit; {time.perf_counter() - t1:.1f} s): " + "; ".join(
                f"{k} " + ", ".join(
                    f"{f} {v[f]:.6g}" for f in (
                        "ms", "plain_ms", "bound_ms", "tflop_s",
                        "g_elem_ops_s", "triangle_bytes_per_item",
                        "triangle_gb_s", "ns_per_pair", "max_rel_err_vs_f64",
                        "g_pairs_s", "gb_s", "library_ms")
                    if isinstance(v.get(f), (int, float)))
                for k, v in res[name].items() if isinstance(v, dict)
                and "ms" in v))
        if "sass" in res[name]:
            log(f"probe {name} SASS: " + "; ".join(
                f"{re.sub(r'_ZN.*?_cu_[0-9a-f]+', '', k)}: " + ", ".join(
                    f"{op} x{n}" for op, n in sorted(ops.items()))
                for k, ops in sorted(res[name]["sass"].items())))
    launched = {name: sum(fn.launches for fn in fns)
                for name, fns in wrappers.items()}
    if not all(launched.values()):
        raise RuntimeError(f"probe kernels never launched: {launched}")
    entries = []
    for kname, (probe, case, replaces, also) in PROBE_KERNELS.items():
        row = res[probe][case]
        entries.append({
            "name": kname, "route": "cuda",
            "source": "vrenderer_tpu_torch/csrc/probes.cu",
            "replaces": replaces, "also_replaces": also,
            "launches": launched[probe], "case": case,
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            "cases": {k: v for k, v in res[probe].items()
                      if isinstance(v, dict) and "ms" in v}})
    print(json.dumps({"probes": {k: {c: v for c, v in r.items()
                                     if c != "sass"}
                                 for k, r in res.items()},
                      "seconds": time.perf_counter() - t0, "device": card}),
          flush=True)
    log(f"probes phase: {time.perf_counter() - t0:.1f} s")
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run "
                         "needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    from vrenderer_tpu_torch.ops import _build

    card = nvidia_smi()
    log(f"environment: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
        f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    ptxas = [ln.split("info    : ")[-1] for ln in
             (lib.parent / "nvcc.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"build: {lib.relative_to(REPO)} in "
        f"{time.perf_counter() - t0:.1f} s; ptxas: {'; '.join(ptxas)}")
    log(f"shared-memory atomics (SASS): {sass_atomics()}")

    r, params, cams = bench_renderer(device)
    prepass = r.cached_horizon_prepass(params)
    phase_kernel("horizon", r, params, prepass, cams)
    phase_modes_kernel(r, params, prepass, cams)
    kern_zid, kern_res = phase_two_phase_kernels(r, params, prepass, cams)
    phase_golden(device)
    single = []
    ms, launched = phase_flythrough("horizon", r, params, cams, prepass,
                                    keep=single)
    # 64 frames + the warm-up frame (the prepass was cached before)
    if launched != launches(raster=65):
        raise RuntimeError(f"horizon path launches {launched}")
    log(f"horizon frame times ({card}): mean {np.mean(ms):.3f} ms, p50 "
        f"{np.median(ms):.3f} ms, max {np.max(ms):.3f} ms over 64 frames "
        f"(CUDA events, 1920x1152)")
    del r
    phase_app(device, card)
    two_ms, two_launches = phase_two_phase_path(device, params, cams, single)
    log(f"two-phase frame times ({card}): mean {np.mean(two_ms):.3f} ms, "
        f"p50 {np.median(two_ms):.3f} ms, max {np.max(two_ms):.3f} ms over "
        f"64 frames (CUDA events, 1920x1152); single-phase in this run: "
        f"mean {np.mean(ms):.3f} ms")
    del single
    phase_mode_frames(device, params, cams)

    rm, _, _ = bench_renderer(device, max_active=MAP_MAX_ACTIVE,
                              shadow_mode="map", shadow_resolution=SHADOW_RES)
    kern_d = phase_depth_kernel(rm, params, cams)
    kern = phase_kernel("map", rm, params, None, cams)
    phase_map_golden(device)
    map_ms, map_launches = phase_flythrough("map", rm, params, cams)
    if map_launches != launches(raster=65, raster_depth=65):
        raise RuntimeError(f"map path launches {map_launches}")
    log(f"map frame times ({card}): mean {np.mean(map_ms):.3f} ms, p50 "
        f"{np.median(map_ms):.3f} ms, max {np.max(map_ms):.3f} ms over 64 "
        f"frames (CUDA events, 1920x1152, light map {SHADOW_RES}^2)")
    del rm
    phase_map_cached(device, params, cams)
    ed_b1, ed_b2, ed_launches = phase_editor(device, card)
    sh_launches, sh = phase_sharded(device, card, params, cams)
    wl_launches, wl_b1, wl_b2 = phase_workloads(device, card)
    probe_entries = phase_probes(device, card)

    src = "vrenderer_tpu_torch/csrc/raster.cu"
    print(json.dumps({"kernels": [
        {"name": "raster", "route": "cuda", "source": src,
         "replaces": "vrenderer_tpu/ops/raster_pallas.py:598",
         "launches": map_launches["raster"], **kern, "library_ms": None,
         "editor_launches": ed_launches["raster"], "editor": ed_b1,
         "sharded_launches": sh_launches["raster"], "sharded": sh["raster"],
         "sharded_map": sh["raster_map"],
         "workloads_launches": wl_launches["raster"], "workloads": wl_b1},
        {"name": "raster_depth", "route": "cuda", "source": src,
         "replaces": "vrenderer_tpu/ops/raster_pallas.py:1121",
         "launches": map_launches["raster_depth"], **kern_d,
         "library_ms": None,
         "editor_launches": ed_launches["raster_depth"], "editor": ed_b2,
         "sharded_launches": sh_launches["raster_depth"],
         "sharded": sh["raster_depth"],
         "workloads_launches": wl_launches["raster_depth"],
         "workloads": wl_b2},
        {"name": "raster_zid", "route": "cuda", "source": src,
         "replaces": "vrenderer_tpu/ops/raster_pallas.py:1209",
         "launches": two_launches["raster_zid"], **kern_zid,
         "library_ms": None, "sharded_launches": sh_launches["raster_zid"],
         "sharded": sh["raster_zid"]},
        {"name": "raster_resolve", "route": "cuda", "source": src,
         "replaces": "vrenderer_tpu/ops/raster_pallas.py:1384",
         "launches": two_launches["raster_resolve"],
         "filter_launches": two_launches["raster_filter"], **kern_res,
         "library_ms": None,
         "sharded_launches": sh_launches["raster_resolve"],
         "sharded_filter_launches": sh_launches["raster_filter"],
         "sharded": sh["raster_resolve"]},
        *probe_entries,
    ]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
