"""The triangle setup kernel ``vrt_setup`` (``raster_cuda.setup_packed``,
csrc/setup.cu) against the plain chain it replaces on the card
(``raster_cuda.setup_packed_plain``: ``raster.setup_components``,
``instance_bbox_components``, ``raster.shift_components_y`` under a band,
``raster.stack_components``, the parts' concatenation and ``pack_setup`` /
``pack_vis``), bit for bit: the visibility and coefficient rows and the
instance bounds (bbox, usable, dist).

Inputs: synthetic parts (the lattice and the indexed form, a ragged last
warp, instances behind, across and in front of the near plane, invalid
instances, degenerate triangles, with and without attribute channels,
with and without a band); and the renderer's own parts, the terrain and
the boot cube's mesh blocks, at cameras of the horizon flythrough (with a
band), the map flythrough's main and light views, the ground ring (whose
instances cross the near plane) and the envelope's orbit.

CPU cases check the dispatch (CPU tensors never reach the kernel) and the
wrapper's checks; CUDA cases (marker ``cuda``) skip where there is no card.
The file imports no JAX, so on the machine with the card it runs without
the repository's conftest:

    python -m pytest tests/test_torch_setup_kernel.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from vrenderer_tpu_torch import workloads
from vrenderer_tpu_torch.camera import Camera, make_view_constants
from vrenderer_tpu_torch.ops import _build, raster, raster_cuda
from vrenderer_tpu_torch.profiler import span

W, H = 96, 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _wtc():
    """A perspective camera a little above the synthetic parts, made on
    the host: some of their vertices lie behind its near plane."""
    cam = Camera(eye=torch.tensor([0.0, 3.0, -6.0]),
                 target=torch.tensor([0.0, 0.0, 4.0]),
                 up=torch.tensor([0.0, 1.0, 0.0]))
    return make_view_constants(cam, W, H, 60.0, 0.5, 100.0)["world_to_clip"]


def _parts(seed=0, num_attrs=8, side=5, n_lattice=4, n_indexed=3):
    """A lattice part (I, S, S, 3) of wavy patches spread along the view
    (the nearest straddles the near plane, one slot invalid, one patch
    squeezed to a line) and an indexed part (I, V, 3) with random triangles,
    degenerate ones among them; both of T = 2 (S - 1)^2 triangles."""
    rng = np.random.default_rng(seed)
    T = 2 * (side - 1) ** 2
    g = np.linspace(-1.0, 1.0, side, dtype=np.float32)
    zz, xx = np.meshgrid(g, g, indexing="ij")
    lat = []
    for i in range(n_lattice):
        cx, cz, s = rng.uniform(-3, 3), -7.0 + 4.0 * i, rng.uniform(1.5, 3)
        y = 0.3 * np.sin(3 * xx + i) * np.cos(2 * zz)
        lat.append(np.stack([cx + s * xx, y, cz + s * zz], -1))
    lat[2][..., 0] = lat[2][0, 0, 0]          # a vertical line: degenerate
    lat[2][..., 2] = lat[2][0, 0, 2]
    world_l = np.asarray(lat, np.float32)
    V = 3 * T
    world_i = rng.uniform(-4, 4, (n_indexed, V, 3)).astype(np.float32)
    world_i[..., 2] += 6.0
    world_i[:, 3:9] = world_i[:, 0:1]         # two degenerate triangles
    idx = rng.permutation(V).reshape(T, 3)
    valid_l = np.ones(n_lattice, bool)
    valid_l[1] = False

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    def attrs(shape):
        return t(rng.uniform(-1, 1, shape + (num_attrs,)).astype(np.float32))

    grid_idx = torch.zeros((T, 3), dtype=torch.int64)
    return [(t(world_l), attrs(world_l.shape[:-1]), t(valid_l), grid_idx),
            (t(world_i), attrs(world_i.shape[:-1]),
             torch.ones(n_indexed, dtype=torch.bool), t(idx.astype(np.int64)))]


def _bits(x):
    x = x.cpu()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(name, got, want):
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, tuple):
            _assert_same(f"{name} {f}", a, b)
            continue
        if b is None:
            assert a is None, (name, f)
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (name, f)
        assert torch.equal(_bits(a), _bits(b)), (name, f)


@pytest.mark.parametrize("num_attrs,y0", [(8, None), (8, 16.0), (0, None),
                                          (0, 32.0)])
def test_the_cpu_takes_the_plain_chain(monkeypatch, num_attrs, y0):
    """On CPU tensors ``setup_packed`` returns the plain chain's rows and
    bounds and never launches the kernel."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the kernel library")

    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    parts, wtc = _parts(num_attrs=num_attrs), _wtc()
    before = raster_cuda.setup_packed.launches
    got = raster_cuda.setup_packed(parts, wtc, W, H, y0)
    assert raster_cuda.setup_packed.launches == before
    _assert_same("cpu", got, raster_cuda.setup_packed_plain(parts, wtc, W, H,
                                                            y0))
    assert (got.tris.coef is None) == (num_attrs == 0)
    assert got.tris.vis.shape == (7, 32, raster_cuda.VIS_STRIDE)
    # the inputs reach every branch: invalid, valid, crossing instances
    assert 0 < int(got.usable.sum()) < 7
    full = torch.tensor([0.0, 0.0, W - 1.0, H - 1.0]) - torch.tensor(
        [0.0, y0 or 0.0, 0.0, y0 or 0.0])
    assert bool((got.bbox == full).all(dim=1).any())
    live = got.tris.vis[..., 12] < raster.F32_FAR
    assert 0 < int(live.sum()) < live.numel()


def _rejected(change):
    parts = [list(p) for p in _parts()]
    wtc = _wtc()
    if change == "world_dtype":
        parts[0][0] = parts[0][0].double()
    elif change == "attrs_dtype":
        parts[1][1] = parts[1][1].half()
    elif change == "valid_dtype":
        parts[0][2] = parts[0][2].to(torch.uint8)
    elif change == "tri_idx_dtype":
        parts[1][3] = parts[1][3].int()
    elif change == "wtc_dtype":
        wtc = wtc.double()
    elif change == "wtc_shape":
        wtc = wtc[:3]
    elif change == "unequal_T":
        parts[1][3] = parts[1][3][:20]
    elif change == "attrs_channels":
        parts[0][1] = parts[0][1][..., :3].contiguous()
    elif change == "mixed_channels":
        parts[1][1] = parts[1][1][..., :0].contiguous()
    elif change == "attrs_shape":
        parts[1][1] = parts[1][1][:, :5]
    elif change == "world_shape":
        parts[1][0] = parts[1][0][..., :2]
    elif change == "world_contiguous":
        parts[0][0] = parts[0][0].transpose(1, 2)
    elif change == "attrs_contiguous":
        parts[1][1] = parts[1][1].transpose(1, 2).contiguous().transpose(1, 2)
    elif change == "wtc_contiguous":
        wtc = wtc.T
    elif change == "part_device":
        parts[1][2] = parts[1][2].to("meta")
    elif change == "kernel_device":
        parts = [[x.to("meta") for x in p] for p in parts]
        wtc = wtc.to("meta")
    return parts, wtc


@pytest.mark.parametrize("change,words", [
    ("world_dtype", ("part 0 world", "torch.float64", "torch.float32")),
    ("attrs_dtype", ("part 1 attrs", "torch.float16")),
    ("valid_dtype", ("part 0 inst_valid", "torch.uint8", "torch.bool")),
    ("tri_idx_dtype", ("part 1 tri_idx", "torch.int32", "torch.int64")),
    ("wtc_dtype", ("world_to_clip", "torch.float64")),
    ("wtc_shape", ("world_to_clip", "(3, 4)", "(4, 4)")),
    ("unequal_T", ("part 1", "20 triangles", "part 0 32")),
    ("attrs_channels", ("part 0 attrs", "3 channels", "(0, 8)")),
    ("mixed_channels", ("part 1 attrs", "0 channels", "part 0 8")),
    ("attrs_shape", ("part 1 attrs", "(3, 5, 8)", "(3, 96, 8)")),
    ("world_shape", ("part 1 world", "(3, 96, 2)")),
    ("world_contiguous", ("part 0 world", "not contiguous")),
    ("attrs_contiguous", ("part 1 attrs", "not contiguous")),
    ("wtc_contiguous", ("world_to_clip", "not contiguous")),
    ("part_device", ("part 1 inst_valid", "meta", "world_to_clip on cpu")),
    ("kernel_device", ("CUDA device", "meta")),
])
def test_setup_packed_names_what_it_rejects(change, words):
    """The wrapper's checks run before any launch, so they hold on the
    CPU: each raises a ValueError naming the input and what it needs."""
    parts, wtc = _rejected(change)
    with pytest.raises(ValueError) as err:
        raster_cuda.setup_packed(parts, wtc, W, H)
    for w in words:
        assert w in str(err.value), (w, str(err.value))


def _on(parts, device):
    return [tuple(x.to(device) for x in p) for p in parts]


def _check_kernel(name, parts, wtc, width, height, y0=None):
    """The kernel's outputs against the plain chain on the card, bit for
    bit, with one launch a part; returns the plain outputs."""
    before = raster_cuda.setup_packed.launches
    got = raster_cuda.setup_packed(parts, wtc, width, height, y0)
    assert raster_cuda.setup_packed.launches == before + len(parts), name
    want = raster_cuda.setup_packed_plain(parts, wtc, width, height, y0)
    _assert_same(name, got, want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_kernel_equals_the_plain_chain_on_synthetic_parts(card, seed):
    """Both index forms, every branch of the setup and a ragged last warp
    (T = 18 and 32), with 8 channels and none, with and without a band."""
    wtc = _wtc().to(card)
    for side in (4, 5):
        for num_attrs in (8, 0):
            parts = _on(_parts(seed, num_attrs, side), card)
            for y0 in (None, 24.0):
                want = _check_kernel(f"seed {seed} side {side} A "
                                     f"{num_attrs} y0 {y0}", parts, wtc, W,
                                     H, y0)
                assert 0 < int(want.usable.sum()) < 7


def _frame_parts(mode, cams_at):
    """(renderer, [(label, parts, world_to_clip, width, height)]) of the
    main view, and in map mode the light view, at ``cams_at``."""
    r, params, cams = workloads.build(mode, device="cuda")
    cfg = r.config
    prepass = (r.cached_horizon_prepass(params)
               if cfg.shadow_mode == "horizon" else None)
    out = []
    with torch.no_grad():
        for i in cams_at:
            vc = r._view(cams.frame(i))
            sh = r._shadow_inputs(vc, params, None, prepass)
            parts, _ = r._raster_parts(vc, params, sh)
            out.append((f"{mode} main {i}", parts, vc["world_to_clip"],
                        cfg.width, cfg.height))
            if cfg.shadow_mode == "map":
                lparts, wtc_l = r._light_parts(params, vc["camera_pos"],
                                               r._scene_wa(params))[:2]
                res = cfg.shadow_resolution
                out.append((f"{mode} light {i}", lparts, wtc_l, res, res))
    return r, out


@pytest.mark.cuda
@pytest.mark.parametrize("mode,cams_at", [
    ("1080p", (0, 13, 40)), ("map", (0, 13)), ("ground", (0, 10, 33)),
    ("envelope", (0, 21))])
def test_kernel_equals_the_plain_chain_on_the_frames_parts(card, mode,
                                                           cams_at):
    """The renderer's parts (terrain slots, then the boot cube's mesh
    blocks) at the workloads' cameras: horizon 1080p (camera 13 also under
    the band of rows 384-767), the map's main view and its depth-only light
    view, the ground ring, whose instances cross the near plane, and the
    envelope's 1024 slots over four surfaces."""
    _, views = _frame_parts(mode, cams_at)
    crossing = 0
    for name, parts, wtc, width, height in views:
        assert len(parts) == 2 and parts[1][0].ndim == 3, name
        want = _check_kernel(name, parts, wtc, width, height)
        assert (want.tris.coef is None) == ("light" in name), name
        full = torch.tensor([0.0, 0.0, width - 1.0, height - 1.0],
                            device=card)
        crossing += int(((want.bbox == full).all(dim=1) & want.usable).sum())
        if name == "1080p main 13":
            _check_kernel(name + " band", parts, wtc, width, height, 384.0)
    if mode == "ground":
        assert crossing > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["1080p", "map"])
def test_a_frames_setup_syncs_nothing(card, mode):
    """A frame's ``Setup`` spans (the main view's, and in map mode the
    light view's) under ``torch.cuda.set_sync_debug_mode("error")``:
    nothing raises."""
    _, views = _frame_parts(mode, (13,))
    mode_before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = []
        for _, parts, wtc, width, height in views:
            with span("Setup"):
                outs.append(raster_cuda.setup_packed(parts, wtc, width,
                                                     height))
    finally:
        torch.cuda.set_sync_debug_mode(mode_before)
    assert len(outs) == (2 if mode == "map" else 1)
    assert all(int(o.usable.sum()) > 0 for o in outs)
