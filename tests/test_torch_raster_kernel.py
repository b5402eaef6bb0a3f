"""The semantics the rasterizers keep on every device: min z with ties to
the lowest id, -0.0 tying +0.0, NaN and invalid triangles never covering,
the inclusive bbox scissor, the wrappers' checks and launch counts, the
depth-only raster's z equal to the full raster's with an F32_FAR (never
NaN) background, reverse-z (farthest wins, ties to the lowest id, -F32_FAR
background), the wireframe cover rule, and the two-phase raster equal to
the single-phase one; adversarial inputs for the kernels' binning, chunked
merge and block test (near-plane-sized bboxes, edges through block-corner
pixel centres, many instances in one supertile, instance-major work lists
with unused slots, ragged frames, regions without items, a hot spot of
3000 sub-pixel triangles with tied depths) against a per-pixel numpy
reference at both region sides; B3b and the winner filter on adversarial work lists and
id images against a numpy reference of their contract; and on the card,
the CUDA kernels B1, B2, B3a, B3b and the filter equal to their plain
versions on whole frames' raster and light-view inputs.

CPU cases run the plain version; CUDA cases (marker ``cuda``) launch the
kernel and skip where there is no card. The file imports no JAX, so on the
machine with the card it runs without the repository's conftest:

    python -m pytest tests/test_torch_raster_kernel.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from vrenderer_tpu_torch.ops import raster as traster
from vrenderer_tpu_torch.ops import raster_cuda

W, H = 256, 128


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device(request.param)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _packed(planes, bbox, valid, device, num_instances=None):
    """PackedTris for hand-made triangles: planes (N, 12) = 3 edges + z,
    attribute planes constant per triangle (attr k = 10 * n + k); one
    instance per triangle unless ``num_instances`` says otherwise."""
    n = planes.shape[0]
    coef = np.zeros((n, 9, 3), np.float32)
    coef[:, 0, 2] = 1.0                        # inv_w = 1
    coef[:, 1:, 2] = 10.0 * np.arange(n)[:, None] + np.arange(8)[None, :]
    setup = traster.TriSetup(
        edge=torch.as_tensor(planes[:, :9].reshape(n, 3, 3)),
        planes=torch.as_tensor(
            np.concatenate([planes[:, 9:12][:, None], coef], 1)),
        bbox=torch.as_tensor(bbox), valid=torch.as_tensor(valid))
    setup = traster.TriSetup(*(x.to(device) for x in setup))
    return raster_cuda.pack_setup(setup, num_instances or n)


def _full_frame_triangle(z):
    """A 'triangle' covering every pixel at constant depth z."""
    return np.array([0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, z], np.float32)


def _raster(packed, device):
    n = packed.vis.shape[0]
    out = raster_cuda.rasterize(
        packed, raster_cuda.full_work_list(n, W, H, device=device), W, H)
    return [x.cpu().numpy() for x in out]


def test_ties_go_to_lowest_id_and_negative_zero_ties_positive_zero(device):
    full = np.array([0, 0, W - 1, H - 1], np.float32)
    neg = np.array([0, 0, 1, 0, 0, 1, 0, 0, 1, -0.0, -0.0, -0.0], np.float32)
    cases = [
        (np.stack([_full_frame_triangle(0.5), _full_frame_triangle(0.5)]), 0),
        # z = -0.0 (bits above every positive z) ties z = +0.0
        (np.stack([_full_frame_triangle(0.0), neg]), 0),
        (np.stack([neg, _full_frame_triangle(0.0)]), 0),
        (np.stack([_full_frame_triangle(0.5), _full_frame_triangle(0.25)]), 1),
    ]
    for planes, winner in cases:
        packed = _packed(planes, np.stack([full, full]),
                         np.array([True, True]), device)
        z, ids, attrs = _raster(packed, device)
        assert np.all(ids == winner)
        assert np.all(attrs[..., 3] == 10.0 * winner + 3)
        assert not np.signbit(z).any()


def test_nan_bbox_and_invalid_triangles_never_cover(device):
    full = np.array([0, 0, W - 1, H - 1], np.float32)
    nan_edge = _full_frame_triangle(0.5)
    nan_edge[0] = np.nan
    planes = np.stack([nan_edge, _full_frame_triangle(0.5),
                       _full_frame_triangle(0.6)])
    bbox = np.stack([full, np.full(4, np.nan, np.float32), full])
    z, ids, attrs = _raster(
        _packed(planes, bbox, np.array([True, True, False]), device), device)
    assert np.all(ids == -1)
    assert np.all(z == raster_cuda.F32_FAR)
    assert np.all(attrs == 0.0)


def test_bbox_scissor_is_inclusive(device):
    planes = _full_frame_triangle(0.5)[None]
    bbox = np.array([[3, 5, 7, 6]], np.float32)
    _, ids, _ = _raster(_packed(planes, bbox, np.array([True]), device),
                        device)
    cov = ids >= 0
    assert cov.sum() == 5 * 2 and cov[5:7, 3:8].all()


def test_wrapper_validates_and_counts_only_kernel_launches(device):
    planes = _full_frame_triangle(0.5)[None]
    full = np.array([[0, 0, W - 1, H - 1]], np.float32)
    packed = _packed(planes, full, np.array([True]), device)
    work = raster_cuda.full_work_list(1, W, H, device=device)
    before = raster_cuda.rasterize.launches
    raster_cuda.rasterize(packed, work, W, H)
    # CPU tensors run the plain version, which is no launch
    assert raster_cuda.rasterize.launches == before + (device.type == "cuda")
    raster_cuda.rasterize(packed, work, W, H, reverse_z=True, wire_px=1.0)
    assert raster_cuda.rasterize.launches == before + 2 * (
        device.type == "cuda")
    with pytest.raises(ValueError):
        raster_cuda.rasterize(packed._replace(vis=packed.vis.double()), work,
                              W, H)
    with pytest.raises(ValueError):
        raster_cuda.rasterize(packed, work._replace(
            items=work.items.to(torch.int64)), W, H)
    with pytest.raises(ValueError):
        strided = torch.zeros((1, 1, 2 * raster_cuda.NUM_COEF),
                              device=device)[..., ::2]
        raster_cuda.rasterize(packed._replace(coef=strided), work, W, H)
    other = torch.device("cpu" if device.type == "cuda" else "meta")
    with pytest.raises(ValueError):
        raster_cuda.rasterize(packed, work._replace(
            items=work.items.to(other)), W, H)


_TIE_CASES = [
    [_full_frame_triangle(0.5), _full_frame_triangle(0.5)],
    [_full_frame_triangle(0.0), np.array([0, 0, 1, 0, 0, 1, 0, 0, 1, -0.0,
                                          -0.0, -0.0], np.float32)],
    [_full_frame_triangle(0.5), _full_frame_triangle(0.25)],
]


@pytest.mark.parametrize("case", range(len(_TIE_CASES)))
def test_depth_raster_is_full_z_with_far_background(device, case):
    """z of the depth-only raster equals the full raster's, -0.0 comes out
    +0.0, and pixels outside the scissored bbox hold exactly F32_FAR."""
    bbox = np.array([[0, 0, W - 1, H - 1], [10, 3, 40, 90]], np.float32)
    packed = _packed(np.stack(_TIE_CASES[case]), bbox, np.array([True, True]),
                     device)
    work = raster_cuda.full_work_list(2, W, H, device=device)
    z = raster_cuda.rasterize_depth(packed.vis, work, W, H)
    z_full = raster_cuda.rasterize(packed, work, W, H)[0]
    assert torch.equal(z, z_full)
    z = z.cpu().numpy()
    assert not np.signbit(z).any() and not np.isnan(z).any()
    # only the first triangle, scissored to its bbox
    packed = _packed(np.stack(_TIE_CASES[case]), bbox[::-1].copy(),
                     np.array([True, False]), device)
    z = raster_cuda.rasterize_depth(packed.vis, work, W, H).cpu().numpy()
    inside = np.zeros((H, W), bool)
    inside[3:91, 10:41] = True
    assert np.all(z[~inside] == raster_cuda.F32_FAR)
    assert np.all(z[inside] < 2.0)


def test_depth_raster_nan_and_invalid_triangles_never_cover(device):
    full = np.array([0, 0, W - 1, H - 1], np.float32)
    nan_edge = _full_frame_triangle(0.5)
    nan_edge[0] = np.nan
    nan_z = _full_frame_triangle(np.nan)
    planes = np.stack([nan_edge, nan_z, _full_frame_triangle(0.5),
                       _full_frame_triangle(0.6)])
    bbox = np.stack([full, full, np.full(4, np.nan, np.float32), full])
    packed = _packed(planes, bbox, np.array([True, True, True, False]),
                     device)
    z = raster_cuda.rasterize_depth(
        packed.vis, raster_cuda.full_work_list(4, W, H, device=device), W, H)
    assert torch.all(z == raster_cuda.F32_FAR)


def test_depth_wrapper_validates_and_counts_only_kernel_launches(device):
    full = np.array([[0, 0, W - 1, H - 1]], np.float32)
    vis = _packed(_full_frame_triangle(0.5)[None], full, np.array([True]),
                  device).vis
    work = raster_cuda.full_work_list(1, W, H, device=device)
    before = raster_cuda.rasterize_depth.launches
    raster_cuda.rasterize_depth(vis, work, W, H)
    assert raster_cuda.rasterize_depth.launches == before + (
        device.type == "cuda")
    bad = [(vis.double(), work), (vis, work._replace(
        items=work.items.to(torch.int64))),
        (torch.zeros((1, 1, 32), device=device)[..., ::2], work),
        (vis, work._replace(items=work.items.to(
            "cpu" if device.type == "cuda" else "meta")))]
    for v, w in bad:
        with pytest.raises(ValueError):
            raster_cuda.rasterize_depth(v, w, W, H)


def _golden_renderer(device, **cfg_kw):
    """tests/test_golden.py's configuration (``cfg_kw``: map mode)."""
    from vrenderer_tpu_torch.config import FrameConfig, TerrainSettings
    from vrenderer_tpu_torch.renderer import Renderer
    from vrenderer_tpu_torch.terrain import heightmap as hmod

    cfg = FrameConfig(width=W, height=H, terrain=TerrainSettings(
        surface_size=64, world_size=64, max_instances=64, grid_size=8),
        **cfg_kw)
    hm = hmod.procedural_heightmap(64, seed=7, device=device)
    return Renderer(cfg, hm, hmod.procedural_albedo(hm), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("eye,target", [
    ([0.0, 25.0, 45.0], [0.0, 0.0, 0.0]),
    ([25.0, 8.0, 25.0], [-10.0, 2.0, -10.0]),
])
def test_cuda_kernel_matches_plain_on_frame_inputs(cuda_device, eye, target):
    """The kernel and its plain version evaluate every plane with the same
    roundings (no FMA), so ids, z and attrs are equal."""
    from vrenderer_tpu_torch.camera import Camera
    from vrenderer_tpu_torch.renderer import FrameParams

    def v(x):
        return torch.tensor(x, dtype=torch.float32, device=cuda_device)

    r = _golden_renderer(cuda_device)
    params = FrameParams.default(device=cuda_device)._replace(
        max_height=v(12.0))
    packed, work = r.raster_inputs(
        Camera(v(eye), v(target), v([0.0, 1.0, 0.0])), params)
    ref = raster_cuda.rasterize_plain(packed, work, W, H)
    before = raster_cuda.rasterize.launches
    out = raster_cuda.rasterize(packed, work, W, H)
    torch.cuda.synchronize()
    assert raster_cuda.rasterize.launches == before + 1
    assert (out[1] >= 0).float().mean() > 0.2
    assert torch.equal(out[1], ref[1])
    assert torch.equal(out[0], ref[0])
    assert torch.equal(out[2], ref[2])


@pytest.mark.cuda
@pytest.mark.parametrize("eye,target", [
    ([0.0, 25.0, 45.0], [0.0, 0.0, 0.0]),
    ([25.0, 8.0, 25.0], [-10.0, 2.0, -10.0]),
])
def test_cuda_depth_kernel_matches_plain_on_light_inputs(cuda_device, eye,
                                                         target):
    """Kernel B2 on a map-mode light pass's inputs: z equal to its plain
    version and to kernel B1's z channel (both min-merge exact z)."""
    from vrenderer_tpu_torch.camera import Camera
    from vrenderer_tpu_torch.renderer import FrameParams

    def v(x):
        return torch.tensor(x, dtype=torch.float32, device=cuda_device)

    res = 256
    r = _golden_renderer(cuda_device, shadow_mode="map",
                         shadow_resolution=res)
    params = FrameParams.default(device=cuda_device)._replace(
        max_height=v(12.0))
    vis, work = r.light_raster_inputs(
        Camera(v(eye), v(target), v([0.0, 1.0, 0.0])), params)
    ref = raster_cuda.rasterize_depth_plain(vis, work, res, res)
    before = raster_cuda.rasterize_depth.launches
    z = raster_cuda.rasterize_depth(vis, work, res, res)
    torch.cuda.synchronize()
    assert raster_cuda.rasterize_depth.launches == before + 1
    assert (z < 2.0).float().mean() > 0.2
    assert torch.equal(z, ref)
    coef = torch.zeros(vis.shape[:2] + (raster_cuda.NUM_COEF,),
                       device=cuda_device)
    z_full = raster_cuda.rasterize(raster_cuda.PackedTris(vis, coef), work,
                                   res, res)[0]
    assert torch.equal(z, z_full)


def _pair(planes, device, bbox=None):
    n = len(planes)
    full = np.array([0, 0, W - 1, H - 1], np.float32)
    return _packed(np.stack(planes), np.stack([full] * n) if bbox is None
                   else bbox, np.ones(n, bool), device)


_NEG = np.array([0, 0, 1, 0, 0, 1, 0, 0, 1, -0.0, -0.0, -0.0], np.float32)


@pytest.mark.parametrize("two_phase", [False, True])
def test_reverse_z_keeps_farthest_with_ties_to_lowest_id(device, two_phase):
    """Reverse-z: the farthest z wins, equal z goes to the lowest id, -0.0
    ties +0.0 and loses to any positive z; the background is -F32_FAR."""
    cases = [
        ([_full_frame_triangle(0.5), _full_frame_triangle(0.5)], 0, 0.5),
        ([_full_frame_triangle(0.5), _full_frame_triangle(0.25)], 0, 0.5),
        ([_full_frame_triangle(0.25), _full_frame_triangle(0.5)], 1, 0.5),
        ([_full_frame_triangle(0.0), _NEG], 0, 0.0),
        ([_NEG, _full_frame_triangle(0.0)], 0, 0.0),
        ([_NEG, _full_frame_triangle(0.25)], 1, 0.25),
    ]
    work = raster_cuda.full_work_list(2, W, H, device=device)
    for planes, winner, zw in cases:
        packed = _pair(planes, device)
        if two_phase:
            z, ids, attrs = raster_cuda.rasterize_two_phase(
                packed, work, W, H, reverse_z=True)
        else:
            z, ids, attrs = raster_cuda.rasterize(packed, work, W, H,
                                                  reverse_z=True)
        z, ids, attrs = (x.cpu().numpy() for x in (z, ids, attrs))
        assert np.all(ids == winner)
        assert np.all(z == np.float32(zw)) and not np.signbit(z).any()
        assert np.all(attrs[..., 3] == 10.0 * winner + 3)
    # only the second triangle, scissored: -F32_FAR outside it
    bbox = np.array([[0, 0, W - 1, H - 1], [10, 3, 40, 90]], np.float32)
    packed = _packed(np.stack([_full_frame_triangle(0.5)] * 2), bbox,
                     np.array([False, True]), device)
    z, ids = raster_cuda.rasterize_zid(packed, work, W, H, reverse_z=True)
    z, ids = z.cpu().numpy(), ids.cpu().numpy()
    inside = np.zeros((H, W), bool)
    inside[3:91, 10:41] = True
    assert np.all(ids[inside] == 1) and np.all(ids[~inside] == -1)
    assert np.all(z[~inside] == -raster_cuda.F32_FAR)


def _wire_triangle():
    """A right triangle with vertices (10, 10), (100, 10), (10, 100) in
    pixels and gradient-normalised edges (E = distance inside)."""
    r = np.float32(1.0 / np.sqrt(2.0))
    planes = np.array([0, 1, -10, 1, 0, -10, -r, -r, 110 * r, 0, 0, 0.5],
                      np.float32)
    return planes[None], np.array([[10, 10, 100, 100]], np.float32)


def test_wireframe_leaves_the_interior_uncovered(device):
    planes, bbox = _wire_triangle()
    packed = _packed(planes, bbox, np.array([True]), device)
    work = raster_cuda.full_work_list(1, W, H, device=device)
    fill = raster_cuda.rasterize(packed, work, W, H)[1].cpu().numpy() >= 0
    z, ids, attrs = raster_cuda.rasterize(packed, work, W, H, wire_px=1.0)
    wire = ids.cpu().numpy() >= 0
    assert fill[50, 50] and not wire[50, 50]
    assert wire[10, 50] and wire[50, 10] and wire[10, 10]
    assert np.all(fill[wire]) and wire.sum() < fill.sum() // 10
    # a pixel covers iff its centre lies within 1 px of an edge
    y, x = np.mgrid[0:H, 0:W].astype(np.float32) + 0.5
    e = np.minimum(np.minimum(y - 10, x - 10),
                   (110 - x - y) / np.float32(np.sqrt(2.0)))
    assert np.all(e[wire] <= 1.0 + 1e-5) and np.all(e[fill & ~wire] > 1.0 - 1e-5)
    assert np.all(attrs.cpu().numpy()[~wire] == 0.0)


def test_two_phase_wrappers_validate_and_count_only_kernel_launches(device):
    packed = _pair([_full_frame_triangle(0.5)], device)
    work = raster_cuda.full_work_list(1, W, H, device=device)
    on_card = device.type == "cuda"
    b_zid = raster_cuda.rasterize_zid.launches
    b_fil = raster_cuda.filter_work_to_winners.launches
    b_res = raster_cuda.rasterize_resolve.launches
    b_b1 = raster_cuda.rasterize.launches
    z, ids = raster_cuda.rasterize_zid(packed, work, W, H)
    work2, live = raster_cuda.filter_work_to_winners(work, ids, 1, W, H)
    assert live.shape == (work.items.shape[0], 8) and live.dtype == torch.bool
    raster_cuda.rasterize_resolve(packed, work2, live, ids, W, H)
    raster_cuda.rasterize_two_phase(packed, work, W, H)
    assert raster_cuda.rasterize_zid.launches == b_zid + 2 * on_card
    assert raster_cuda.filter_work_to_winners.launches == b_fil + 2 * on_card
    assert raster_cuda.rasterize_resolve.launches == b_res + 2 * on_card
    assert raster_cuda.rasterize.launches == b_b1
    other = "cpu" if on_card else "meta"
    bad_filter = [(work, ids.long()), (work, ids[:, :-1].contiguous()),
                  (work, ids.t()), (work, ids.to(other)),
                  (work._replace(items=work.items.long()), ids),
                  (work._replace(items=work.items.t()), ids),
                  (work._replace(items=work.items[:, :1].contiguous()), ids)]
    for w, i in bad_filter:
        with pytest.raises(ValueError):
            raster_cuda.filter_work_to_winners(w, i, 1, W, H)
    assert raster_cuda.filter_work_to_winners.launches == b_fil + 2 * on_card
    with pytest.raises(ValueError):
        raster_cuda.rasterize_zid(packed._replace(vis=packed.vis.double()),
                                  work, W, H)
    with pytest.raises(ValueError):
        raster_cuda.rasterize_zid(packed, work._replace(
            items=work.items.to(other)), W, H)
    bad = [(live.to(torch.uint8), ids), (live[:, :4].contiguous(), ids),
           (live, ids.long()), (live, ids[:, :-1].contiguous()),
           (live, ids.t()), (live.to(other), ids)]
    for lv, i in bad:
        with pytest.raises(ValueError):
            raster_cuda.rasterize_resolve(packed, work2, lv, i, W, H)
    with pytest.raises(ValueError):      # cells must tile the supertile
        raster_cuda.rasterize_resolve(packed, work2, live, ids, W, H,
                                      sub_h=24)
    with pytest.raises(ValueError):
        raster_cuda.filter_work_to_winners(work, ids, 1, W, H, win_w=96)
    assert raster_cuda.rasterize_resolve.launches == b_res + 2 * on_card


@pytest.mark.parametrize("eye,target", [
    ([0.0, 25.0, 45.0], [0.0, 0.0, 0.0]),
    ([25.0, 8.0, 25.0], [-10.0, 2.0, -10.0]),
])
def test_two_phase_equals_single_phase_on_frame_inputs(device, eye, target):
    """The two-phase raster equals ``rasterize`` bit for bit, in both depth
    directions; on the card each phase also equals its plain version."""
    from vrenderer_tpu_torch.camera import Camera
    from vrenderer_tpu_torch.renderer import FrameParams

    def v(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    r = _golden_renderer(device)
    params = FrameParams.default(device=device)._replace(max_height=v(12.0))
    packed, work = r.raster_inputs(
        Camera(v(eye), v(target), v([0.0, 1.0, 0.0])), params)
    T = packed.vis.shape[1]
    for reverse_z in (False, True):
        ref = raster_cuda.rasterize(packed, work, W, H, reverse_z=reverse_z)
        out = raster_cuda.rasterize_two_phase(packed, work, W, H,
                                              reverse_z=reverse_z)
        assert (ref[1] >= 0).float().mean() > 0.2
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        z, ids = raster_cuda.rasterize_zid(packed, work, W, H,
                                           reverse_z=reverse_z)
        work2, live = raster_cuda.filter_work_to_winners(work, ids, T, W, H)
        assert int(live.sum()) < int((work.items[:, 0] >= 0).sum()) * 8
        if device.type == "cuda":
            zp, idp = raster_cuda.rasterize_zid_plain(packed, work, W, H,
                                                      reverse_z=reverse_z)
            assert torch.equal(z, zp) and torch.equal(ids, idp)
            attrs = raster_cuda.rasterize_resolve(packed, work2, live, ids,
                                                  W, H)
            assert torch.equal(attrs, raster_cuda.rasterize_resolve_plain(
                packed, work2, live, ids, W, H))
            for wire_px in (0.0, 1.0):
                if not (reverse_z or wire_px):
                    continue     # test_cuda_kernel_matches_plain_on_frame_inputs
                b1 = raster_cuda.rasterize(packed, work, W, H,
                                           reverse_z=reverse_z,
                                           wire_px=wire_px)
                pl = raster_cuda.rasterize_plain(packed, work, W, H,
                                                 reverse_z=reverse_z,
                                                 wire_px=wire_px)
                for a, b in zip(b1, pl):
                    assert torch.equal(a, b)


def _adversarial(case):
    """(planes (N, 12), bbox (N, 4), instances, items (n, 2), width,
    height) of one adversarial input for the region kernels."""
    big = np.float32(1e4)
    full = [0, 0, W - 1, H - 1]
    if case == "crossing":
        # near-plane-sized: full-frame bboxes, huge edge coefficients, one
        # covering the left half, one whose z leaves [0, 1.01] on a band
        planes = np.array([
            [-big, 0, big * 127.3, 0, big, big * 50, 0, 0, big * 90,
             1e-4, 2e-4, 0.3],
            [0, 0, 1, 0, 0, 1, 0, 0, 1, 0.01, 0, -1.0],
            [1, 0, -60, 0, 1, -40, -1, -1, 160, 0, 0, 0.2]], np.float32)
        bbox = np.array([full, full, [58, 38, 104, 84]], np.float32)
        return planes, bbox, 3, _supertile_major(3), W, H
    if case == "block_edges":
        # edges through the pixel centres of 8x8 block boundaries (x = 7,
        # x = 8, the diagonal x = y), a -0.0 edge, a tall 5-px-wide rect
        planes = np.array([
            [-1, 0, 7.5, 0, 0, 1, 0, 0, 1, 0, 0, 0.5],
            [1, 0, -8.5, 0, 0, 1, 0, 0, 1, 0, 0, 0.6],
            [1, -1, 0, -0.0, -0.0, -0.0, 0, 0, 1, 0, 0, 0.4],
            [0, 0, 1, 0, 0, 1, -1, 0, 67.5, 0, 0, 0.45]], np.float32)
        bbox = np.array([[0, 0, 40, 40], [0, 0, 40, 40], [16, 16, 63, 63],
                         [63, 10, 67, 100]], np.float32)
        return planes, bbox, 4, _supertile_major(4), W, H
    if case == "many_instances":
        # 40 instances in supertile 1, overlapping, some at equal depth
        n = 40
        rng = np.random.default_rng(3)
        x0 = rng.integers(128, 230, n)
        y0 = rng.integers(0, 100, n)
        planes = np.tile(_full_frame_triangle(0.5), (n, 1))
        planes[:, 11] = np.round(rng.uniform(0.1, 0.9, n), 1)
        bbox = np.stack([x0, y0, x0 + rng.integers(5, 60, n),
                         y0 + rng.integers(5, 60, n)], 1).astype(np.float32)
        return planes, bbox, n, _supertile_major(n), W, H
    if case == "instance_major":
        # (instance, supertile) pairs instance-major, with unused slots
        planes = np.stack([_full_frame_triangle(0.5),
                           _full_frame_triangle(0.25),
                           np.array([1, 0, -20, 0, 1, -20, -1, -1, 300, 0.001,
                                     0, 0.1], np.float32)])
        bbox = np.array([[0, 0, 200, 100], [30, 10, 200, 120],
                         [19, 19, 260, 260]], np.float32)
        items = []
        for i in range(3):
            for st in range(2):
                items += [[i, st], [-1, -1], [-1, st]]
        return planes, bbox, 3, np.array(items, np.int32), W, H
    if case == "ragged":
        w, h = 250, 120
        planes = np.stack([
            np.array([-1, 0, 240.5, 0, -1, 115.5, 0, 0, 1, 0, 0, 0.5],
                     np.float32),
            np.array([1, 0, -150, 0, 0, 1, 0, 0, 1, 0.001, 0, 0.2],
                     np.float32)])
        bbox = np.array([[0, 0, w - 1, h - 1], [140, 50, w - 1, h - 1]],
                        np.float32)
        items = np.array([[i, st] for st in range(2) for i in range(2)],
                         np.int32)
        return planes, bbox, 2, items, w, h
    if case == "hot_spot":
        # 3000 sub-pixel triangles piled on a 6x6-px spot of supertile 0
        # (each covers its pixel centre, some a neighbour too), their depths
        # from four values (ties to the lowest id), in random order, over a
        # floor on supertile 0
        n = 3000
        rng = np.random.default_rng(5)
        cx = (rng.integers(40, 46, n) + 0.5).astype(np.float32)
        cy = (rng.integers(20, 26, n) + 0.5).astype(np.float32)
        reach = rng.choice(np.float32([0.2, 0.7, 1.2]), n)
        planes = np.zeros((n + 1, 12), np.float32)
        planes[:n, 0], planes[:n, 2] = 1, -(cx - np.float32(0.3))
        planes[:n, 4], planes[:n, 5] = 1, -(cy - np.float32(0.3))
        planes[:n, 6], planes[:n, 7] = -1, -1
        planes[:n, 8] = cx + cy + reach
        planes[:n, 11] = rng.choice(np.float32([0.25, 0.5, 0.5, 0.75]), n)
        planes[n] = _full_frame_triangle(0.9)
        bbox = np.concatenate([
            np.stack([cx - 0.5, cy - 0.5, cx + reach + 0.3,
                      cy + reach + 0.3], 1),
            np.float32([[0, 0, 127, H - 1]])]).astype(np.float32)
        return planes, bbox, 1, _supertile_major(1), W, H
    if case == "region_without_items":
        # triangles over the whole frame, items only for supertile 0:
        # supertile 1 stays background
        planes = np.stack([_full_frame_triangle(0.5),
                           _full_frame_triangle(0.3)])
        bbox = np.array([full, full], np.float32)
        return planes, bbox, 2, np.array([[0, 0], [1, 0], [-1, -1]],
                                         np.int32), W, H
    raise ValueError(case)


ADVERSARIAL = ("crossing", "block_edges", "many_instances", "instance_major",
               "ragged", "region_without_items", "hot_spot")
# region sides of the region kernels: the default and the whole supertile.
# At CHUNK pairs a chunk, the hot spot's 64-px region and the 128-px
# regions of crossing, many_instances, instance_major, ragged and
# region_without_items are split over several raster blocks, which merge
# through the key image's global atomics.
KERNEL_LAYOUTS = (raster_cuda.REGION, 128)


def _supertile_major(n_inst, width=W, height=H):
    n_st = -(-width // 128) * -(-height // 128)
    return np.array([[i, st] for st in range(n_st) for i in range(n_inst)],
                    np.int32)


def adversarial_inputs(case, device):
    """(packed, work, width, height) of an adversarial case."""
    planes, bbox, n_inst, items, w, h = _adversarial(case)
    packed = _packed(planes, bbox, np.ones(len(planes), bool), device,
                     n_inst)
    work = raster_cuda.WorkList(
        items=torch.as_tensor(items, device=device),
        num_items=torch.tensor(len(items), device=device))
    return packed, work, w, h


def _per_pixel_reference(vis, items, width, height, reverse_z, wire_px=0.0,
                         tile=128):
    """z and id per pixel, evaluated pair by pair in numpy float32 (one
    rounding per operation, like the kernels) over each item's bbox ∩
    supertile."""
    tiles_x = -(-width // tile)
    T = vis.shape[1]
    keys = np.full(width * height, np.iinfo(np.int64).max, np.int64)
    for inst, st in items:
        if inst < 0:
            continue
        tx0, ty0 = st % tiles_x * tile, st // tiles_x * tile
        tx1, ty1 = min(tx0 + tile, width) - 1, min(ty0 + tile, height) - 1
        for t in range(T):
            c = vis[inst, t]
            bx0, by0, bx1, by1 = c[12:16]
            if not (bx0 <= tx1 and bx1 >= tx0 and by0 <= ty1
                    and by1 >= ty0):
                continue
            ys, xs = np.mgrid[int(max(np.ceil(by0), ty0)):
                              int(min(np.floor(by1), ty1)) + 1,
                              int(max(np.ceil(bx0), tx0)):
                              int(min(np.floor(bx1), tx1)) + 1]
            px = xs.astype(np.float32) + np.float32(0.5)
            py = ys.astype(np.float32) + np.float32(0.5)
            e = [c[j] * px + c[j + 1] * py + c[j + 2] for j in (0, 3, 6, 9)]
            zq = e[3]
            cover = ((e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0) & (zq >= 0)
                     & (zq <= np.float32(1.01)))
            if wire_px > 0:
                cover &= np.minimum(e[0], np.minimum(e[1], e[2])) <= wire_px
            zkey = (zq[cover] + np.float32(0.0)).view(np.int32).astype(
                np.int64)
            if reverse_z:
                zkey ^= 0x7FFFFFFF
            np.minimum.at(keys, ys[cover] * width + xs[cover],
                          (zkey << 32) | (inst * T + t))
    bg = keys == np.iinfo(np.int64).max
    zkey = keys >> 32
    if reverse_z:
        zkey ^= 0x7FFFFFFF
    far = -raster_cuda.F32_FAR if reverse_z else raster_cuda.F32_FAR
    z = np.where(bg, far, zkey.astype(np.int32).view(np.float32))
    ids = np.where(bg, -1, keys & 0xFFFFFFFF).astype(np.int32)
    return z.reshape(height, width), ids.reshape(height, width)


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_adversarial_inputs_match_per_pixel_reference(device, case):
    """B1 (filled, reverse-z, wireframe), B3a and B2 on inputs aimed at the
    binning, the chunked merge and the block test equal a pair-by-pair
    reference, at both region sizes of the kernels, with regions of one
    chunk and regions split over several."""
    packed, work, w, h = adversarial_inputs(case, device)
    vis = packed.vis.cpu().numpy()
    items = work.items.cpu().numpy()
    modes = ((False, 0.0), (True, 0.0), (False, 1.0))
    refs = {m: _per_pixel_reference(vis, items, w, h, *m) for m in modes}
    for region in KERNEL_LAYOUTS:
        kw = {"region": region}
        for reverse_z, wire_px in modes:
            z_ref, id_ref = refs[reverse_z, wire_px]
            z, ids, attrs = (x.cpu().numpy() for x in raster_cuda.rasterize(
                packed, work, w, h, reverse_z=reverse_z, wire_px=wire_px,
                **kw))
            assert np.array_equal(ids, id_ref), (kw, reverse_z, wire_px)
            assert np.array_equal(z, z_ref)
            assert not np.signbit(z[ids >= 0]).any()
            assert np.all(np.where(ids[..., None] >= 0,
                                   attrs == 10.0 * ids[..., None]
                                   + np.arange(8), attrs == 0.0))
            if wire_px == 0.0:
                z2, ids2 = raster_cuda.rasterize_zid(
                    packed, work, w, h, reverse_z=reverse_z, **kw)
                assert np.array_equal(ids2.cpu().numpy(), id_ref)
                assert np.array_equal(z2.cpu().numpy(), z_ref)
            if not (reverse_z or wire_px):
                zd = raster_cuda.rasterize_depth(packed.vis, work, w, h, **kw)
                assert np.array_equal(zd.cpu().numpy(), z_ref)
                assert 0 < (id_ref >= 0).mean() < 1


def test_region_side_and_tiles_the_kernels_cannot_hold(device):
    """A region divides the supertile or is the whole supertile; a tile
    whose region's keys and stage buffers would not fit in shared memory,
    or more than 16 regions a supertile raise before any launch, on every
    device."""
    assert raster_cuda.region_side(128) == 64
    assert raster_cuda.region_side(128, 128) == 128
    assert raster_cuda.region_side(96) == 96
    assert raster_cuda.region_side(32) == 32
    assert raster_cuda.region_side(256) == 64
    with pytest.raises(ValueError):
        raster_cuda.region_side(512, 64)    # 64 regions a supertile
    packed = _pair([_full_frame_triangle(0.5)], device)
    work = raster_cuda.full_work_list(1, W, H, tile=200, device=device)
    before = raster_cuda.rasterize.launches
    for bad in ({"tile": 200}, {"tile": 128, "region": 0},
                {"tile": 128, "region": -64}):
        with pytest.raises(ValueError):
            raster_cuda.rasterize(packed, work, W, H, **bad)
        with pytest.raises(ValueError):
            raster_cuda.rasterize_zid(packed, work, W, H, **bad)
    with pytest.raises(ValueError):
        raster_cuda.rasterize_depth(packed.vis, work, W, H, tile=240)
    with pytest.raises(ValueError):
        raster_cuda.rasterize_depth(packed.vis, work, W, H, tile=128,
                                    region=0)
    assert raster_cuda.rasterize.launches == before
    # B2's 4-byte keys fit a 200-px tile
    z = raster_cuda.rasterize_depth(packed.vis, work, W, H, tile=200)
    assert torch.all(z == 0.5)


RESOLVE_CASES = ("interleaved", "duplicates", "ragged", "limit",
                 "background", "empty")
CELLS = ((16, 128), (8, 128), (16, 64), (8, 64))   # (sub_h, win_w)


def _resolve_inputs(case, sub_h, win_w, tile=128):
    """(coef (I, T, 27), ids (h, w) int32, items (n, 2) int32, live (n,
    n_cell) bool, w, h) for B3b and the filter: 8x8 blocks of a few
    instances' ids with scattered background pixels, every (instance,
    supertile) pair they hold plus absent ones, shuffled among unused slots
    (some with a supertile), random live rows (dead cells holding winners,
    live bits on unused slots)."""
    rng = np.random.default_rng(RESOLVE_CASES.index(case) * 10 + sub_h
                                + win_w)
    w, h = (250, 120) if case == "ragged" else (W, H)
    I, T = ((raster_cuda.MAX_RESOLVE_INSTANCES, 1) if case == "limit"
            else (37, 3))
    tiles_x = -(-w // tile)
    n_st = tiles_x * -(-h // tile)
    pool = rng.choice(I, size=12, replace=False)
    if case == "limit":
        pool[:4] = [I - 1, I - 32, 31, 32]      # bitmap word edges
    blk = rng.choice(pool, size=(-(-h // 8), -(-w // 8)))
    inst = np.repeat(np.repeat(blk, 8, 0), 8, 1)[:h, :w]
    ids = (inst * T + rng.integers(0, T, (h, w))).astype(np.int32)
    ids[rng.random((h, w)) < 0.2] = -1
    if case == "background":
        ids[:] = -1
    y, x = np.mgrid[0:h, 0:w]
    st = (y // tile) * tiles_x + x // tile
    cov = ids >= 0
    pairs = {(int(i), int(s)) for i, s in zip(ids[cov] // T, st[cov])}
    pairs |= {(int(i), int(s)) for i, s in
              zip(rng.choice(pool, 6), rng.integers(0, n_st, 6))}
    items = [list(p) for p in sorted(pairs)]
    if case == "duplicates":
        items += [list(p) for p in sorted(pairs)[::2]]
    items += [[-1, -1]] * 5 + [[-1, s] for s in range(n_st)]
    items = np.array(items, np.int32)[rng.permutation(len(items))]
    if case == "empty":
        items = np.zeros((0, 2), np.int32)
    n_cell = (tile // sub_h) * (tile // win_w)
    live = rng.random((len(items), n_cell)) < 0.6
    coef = rng.normal(size=(I, T, raster_cuda.NUM_COEF)).astype(np.float32)
    return coef, ids, items, live, w, h


def _resolve_reference(coef, ids, items, live, sub_h, win_w, tile=128):
    """attrs per pixel in numpy float32 (one rounding per operation): the
    winner's where some slot holds its (instance, supertile) item live at
    the pixel's cell, else 0."""
    h, w = ids.shape
    T = coef.shape[1]
    n_win = tile // win_w
    n_cell = (tile // sub_h) * n_win
    tiles_x = -(-w // tile)
    y, x = np.mgrid[0:h, 0:w]
    st = (y // tile) * tiles_x + x // tile
    cell = ((y % tile) // sub_h) * n_win + (x % tile) // win_w
    k, c = np.nonzero(live & (items[:, :1] >= 0))
    on = (items[k, 0].astype(np.int64) * 10_000 + items[k, 1]) * n_cell + c
    key = ((ids // T).astype(np.int64) * 10_000 + st) * n_cell + cell
    write = (ids >= 0) & np.isin(key, on)
    cf = coef.reshape(-1, raster_cuda.NUM_COEF)[np.where(write, ids, 0)]
    px = x.astype(np.float32) + np.float32(0.5)
    py = y.astype(np.float32) + np.float32(0.5)

    def plane(j):
        return cf[..., j] * px + cf[..., j + 1] * py + cf[..., j + 2]

    inv_w = plane(0)
    denom = np.where(np.abs(inv_w) > np.float32(1e-20), inv_w,
                     np.float32(1.0))
    attrs = np.stack([plane(3 * (a + 1)) / denom for a in range(8)], -1)
    return np.where(write[..., None], attrs, np.float32(0.0))


def _filter_reference(items, ids, T, sub_h, win_w, tile=128):
    """(items2, live) of the filter: per cell the [min, max] of id // T over
    its covered in-frame pixels; an item is live at a cell iff its
    instance lies in that range."""
    h, w = ids.shape
    tiles_x = -(-w // tile)
    n_sub, n_win = tile // sub_h, tile // win_w
    rows, cols = -(-h // tile) * n_sub, tiles_x * n_win
    mn = np.full((rows, cols), 2 ** 30, np.int64)
    mx = np.full((rows, cols), -1, np.int64)
    y, x = np.nonzero(ids >= 0)
    np.minimum.at(mn, (y // sub_h, x // win_w), ids[y, x] // T)
    np.maximum.at(mx, (y // sub_h, x // win_w), ids[y, x] // T)
    c = np.arange(n_sub * n_win)[None, :]
    inst, st = items[:, :1].astype(np.int64), items[:, 1:]
    r = (st // tiles_x) * n_sub + c // n_win
    q = (st % tiles_x) * n_win + c % n_win
    used = inst >= 0
    r, q = np.where(used, r, 0), np.where(used, q, 0)
    live = used & (mn[r, q] <= inst) & (inst <= mx[r, q])
    return np.where(live.any(1, keepdims=True), items, -1), live


@pytest.mark.parametrize("case", RESOLVE_CASES)
def test_resolve_and_filter_match_per_pixel_reference(device, case):
    """B3b and the winner filter on adversarial inputs (unused slots among
    items in any order, duplicated items with mixed live rows, dead cells
    holding winners, a ragged 250x120 frame, 37 instance slots and the
    bitmap's limit, an all-background image, an empty work list) at every
    cell shape of the configs (B3b's 16-row bands hold one or two cell
    rows) equal a per-pixel numpy reference of the contract; B3b also with
    coefficients off a 16-byte boundary and after the filter."""
    for sub_h, win_w in CELLS:
        coef, ids, items, live, w, h = _resolve_inputs(case, sub_h, win_w)
        I, T = coef.shape[:2]
        packed = raster_cuda.PackedTris(
            vis=torch.zeros((I, T, raster_cuda.VIS_STRIDE), device=device),
            coef=torch.as_tensor(coef, device=device))
        work = raster_cuda.WorkList(
            items=torch.as_tensor(items, device=device),
            num_items=torch.tensor(len(items), device=device))
        tid = torch.as_tensor(ids, device=device)
        cells = {"sub_h": sub_h, "win_w": win_w}
        ref = _resolve_reference(coef, ids, items, live, sub_h, win_w)
        attrs = raster_cuda.rasterize_resolve(
            packed, work, torch.as_tensor(live, device=device), tid, w, h,
            **cells)
        assert np.array_equal(attrs.cpu().numpy(), ref), (sub_h, win_w)
        # coefficients 4 bytes past a 16-byte boundary: read float by float
        shifted = torch.zeros(coef.size + 1, device=device)[1:]
        shifted.copy_(packed.coef.reshape(-1))
        attrs = raster_cuda.rasterize_resolve(
            packed._replace(coef=shifted.view(coef.shape)), work,
            torch.as_tensor(live, device=device), tid, w, h, **cells)
        assert np.array_equal(attrs.cpu().numpy(), ref)
        items2, live2 = _filter_reference(items, ids, T, sub_h, win_w)
        work2, tlive2 = raster_cuda.filter_work_to_winners(work, tid, T, w, h,
                                                           **cells)
        assert np.array_equal(work2.items.cpu().numpy(), items2)
        assert np.array_equal(tlive2.cpu().numpy(), live2)
        assert int(work2.num_items) == len(items)
        attrs = raster_cuda.rasterize_resolve(packed, work2, tlive2, tid, w,
                                              h, **cells)
        ref2 = _resolve_reference(coef, ids, items2, live2, sub_h, win_w)
        assert np.array_equal(attrs.cpu().numpy(), ref2)
        # the filter keeps every winner's own item live
        assert np.array_equal(ref2 != 0, _resolve_reference(
            coef, ids, items, np.ones_like(live), sub_h, win_w) != 0)


def test_resolve_raises_above_the_instance_limit(device):
    """One instance slot past the bitmap's limit raises before any launch,
    on every device."""
    I = raster_cuda.MAX_RESOLVE_INSTANCES + 1
    packed = raster_cuda.PackedTris(
        vis=torch.zeros((I, 1, raster_cuda.VIS_STRIDE), device=device),
        coef=torch.zeros((I, 1, raster_cuda.NUM_COEF), device=device))
    work = raster_cuda.full_work_list(I, W, H, device=device)
    ids = torch.full((H, W), -1, dtype=torch.int32, device=device)
    live = torch.ones((work.items.shape[0], 8), dtype=torch.bool,
                      device=device)
    before = raster_cuda.rasterize_resolve.launches
    with pytest.raises(ValueError):
        raster_cuda.rasterize_resolve(packed, work, live, ids, W, H)
    assert raster_cuda.rasterize_resolve.launches == before


def test_winner_rows_gathers_each_pixels_coefficients(device):
    """B1's output gather alone (``winner_rows``): row i is the winner's 27
    coefficients, zeros on the background, for runs of equal winners,
    scattered winners and a length that is no multiple of a warp; bad
    inputs raise before any launch."""
    rng = np.random.default_rng(9)
    coef = torch.as_tensor(rng.normal(size=(5, 7, raster_cuda.NUM_COEF))
                           .astype(np.float32), device=device)
    ids = rng.integers(-1, 35, 1000).astype(np.int32)
    ids[100:300] = 17
    ids[500:540] = -1
    tid = torch.as_tensor(ids, device=device)
    rows = raster_cuda.winner_rows(coef, tid).cpu().numpy()
    flat = coef.reshape(-1, raster_cuda.NUM_COEF).cpu().numpy()
    want = np.where(ids[:, None] >= 0, flat[np.maximum(ids, 0)], 0.0)
    assert np.array_equal(rows, want)
    before = raster_cuda.winner_rows.launches
    for bad in ((coef.double(), tid), (coef, tid.long()),
                (coef[..., :26].contiguous(), tid)):
        with pytest.raises(ValueError):
            raster_cuda.winner_rows(*bad)
    assert raster_cuda.winner_rows.launches == before
