"""The block test of kernels B1, B2 and B3a, through its PyTorch mirror
``raster_cuda.block_pair_rects`` (same 8x8 blocks, same margin, same
roundings as ``block_live`` in csrc/raster.cu): it never drops a block that
holds a covered (triangle, pixel) pair, on the 256x128 golden frame's
inputs, on the adversarial inputs of test_torch_raster_kernel.py and on
random planes through block corners, and it evaluates fewer pairs than the
bbox walk of ``pair_rects``. CPU only: the mirror is plain PyTorch.

    python -m pytest tests/test_torch_raster_blocks.py -q
"""

import numpy as np
import pytest
import torch

from test_torch_raster_kernel import (ADVERSARIAL, H, W, _golden_renderer,
                                      adversarial_inputs)
from vrenderer_tpu_torch.ops import raster_cuda

_VIEWS = {"front": ([0.0, 25.0, 45.0], [0.0, 0.0, 0.0]),
          "side": ([25.0, 8.0, 25.0], [-10.0, 2.0, -10.0])}


def _random_planes(seed=11, n=300):
    """Triangles whose edges and z planes pass through or near pixel
    centres of 8x8 block corners at random slopes and scales (1e-3 to
    1e4), bboxes of 9 to 120 px a side; one instance of n triangles."""
    rng = np.random.default_rng(seed)
    planes = np.zeros((n, 12), np.float32)
    x0 = rng.integers(0, W - 16, n)
    y0 = rng.integers(0, H - 16, n)
    bw = np.minimum(rng.integers(9, 120, n), W - 1 - x0)
    bh = np.minimum(rng.integers(9, 120, n), H - 1 - y0)
    for j in range(4):
        ang = rng.uniform(0, 2 * np.pi, n)
        scale = 10.0 ** rng.uniform(-3, 4, n)
        # through a block corner's pixel centre, nudged by a few ulps
        cx = x0 + 8 * rng.integers(0, 8, n) + rng.choice([-0.5, 0.5, 7.5], n)
        cy = y0 + 8 * rng.integers(0, 8, n) + rng.choice([-0.5, 0.5, 7.5], n)
        a = (np.cos(ang) * scale).astype(np.float32)
        b = (np.sin(ang) * scale).astype(np.float32)
        c = -(a * cx.astype(np.float32) + b * cy.astype(np.float32))
        c = c * (1 + rng.integers(-4, 5, n) * np.float32(2 ** -23))
        if j == 3:                       # z around 0 or 1.01 at the corner
            c = c + rng.choice([0.0, 1.01], n).astype(np.float32)
        planes[:, 3 * j:3 * j + 3] = np.stack([a, b, c], 1)
    bbox = np.stack([x0, y0, x0 + bw, y0 + bh], 1).astype(np.float32)
    vis = np.concatenate([planes, bbox], 1)[None].astype(np.float32)
    return (torch.as_tensor(vis),
            raster_cuda.full_work_list(1, W, H, device="cpu"), W, H)


def _inputs(case):
    """(vis, work, width, height) on the CPU."""
    if case in _VIEWS:
        from vrenderer_tpu_torch.camera import Camera
        from vrenderer_tpu_torch.renderer import FrameParams

        def v(x):
            return torch.tensor(x, dtype=torch.float32)

        r = _golden_renderer(torch.device("cpu"))
        params = FrameParams.default(device="cpu")._replace(
            max_height=v(12.0))
        eye, target = _VIEWS[case]
        packed, work = r.raster_inputs(
            Camera(v(eye), v(target), v([0.0, 1.0, 0.0])), params)
        return packed.vis, work, W, H
    if case == "random":
        return _random_planes()
    packed, work, w, h = adversarial_inputs(case, torch.device("cpu"))
    return packed.vis, work, w, h


CASES = sorted(_VIEWS) + ["random"] + list(ADVERSARIAL)


def _covered(vis, work, w, h, rects=None):
    """The sorted (pixel, global id) keys of the covered pairs."""
    keys = [pix * (1 << 32) + gid for pix, _, gid in raster_cuda._covered_pairs(
        vis, work, w, h, raster_cuda.TILE, 1 << 20, rects=rects)]
    return torch.sort(torch.cat(keys)).values


@pytest.mark.parametrize("region", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_block_test_keeps_every_covered_pair(case, region):
    vis, work, w, h = _inputs(case)
    blocks = raster_cuda.block_pair_rects(vis, work, w, h, region=region)
    covered = _covered(vis, work, w, h)
    assert covered.numel() > 0
    assert torch.equal(_covered(vis, work, w, h, blocks), covered)
    # every evaluated pair lies in the pair's bbox ∩ its item's supertile,
    # each at most once (no block or region is walked twice)
    bbox = raster_cuda.pair_rects(vis, work, w, h)
    assert int(blocks.cnt.sum()) <= int(bbox.cnt.sum())
    assert bool((blocks.cnt > 0).all()) and bool((blocks.wd > 0).all())


@pytest.mark.parametrize("case", CASES)
def test_block_test_evaluates_fewer_pairs_than_the_bbox_walk(case):
    """Strictly fewer wherever a triangle's bbox in a region exceeds one
    block and holds pixels no edge can reach (crossing triangles, the
    golden views' silhouettes, random planes); never more."""
    vis, work, w, h = _inputs(case)
    n_bbox = int(raster_cuda.pair_rects(vis, work, w, h).cnt.sum())
    n_blocks = int(raster_cuda.block_pair_rects(vis, work, w, h).cnt.sum())
    n_covered = _covered(vis, work, w, h).numel()
    assert n_covered <= n_blocks <= n_bbox
    if case in ("front", "side", "random", "crossing", "block_edges"):
        assert n_blocks < n_bbox
    if case == "crossing":
        assert n_blocks < n_bbox // 2


def test_block_test_edge_cases():
    """One block [8, 15] x [8, 15] against single planes: an edge through
    its corner pixel centre or -0.0 everywhere keeps it, one just outside
    drops it, NaN drops it, an overflowing margin keeps it, and z is kept
    only where [0, 1.01] can be met."""
    def live(*plane_rows):
        pc = torch.tensor(np.array(plane_rows, np.float32))
        n = pc.shape[0]
        c = torch.full((n,), 8, dtype=torch.long)
        return raster_cuda._blocks_live(pc, c, c, c + 7, c + 7).tolist()

    ok = [0, 0, 1]
    z = [0, 0, 0.5]
    assert live([-1, 0, 8.5] + ok + ok + z,        # 0 at x = 8's centre
                [-1, 0, 8.4999] + ok + ok + z,     # just outside
                [-0.0, -0.0, -0.0] + ok + ok + z,
                [np.nan, 0, 1] + ok + ok + z,
                [3e38, 3e38, -3e38] + ok + ok + z,
                ok + ok + ok + [0, 0, 1.01],
                ok + ok + ok + [0, 0, 1.0101],
                ok + ok + ok + [-1, 0, 8.5],       # z = 0 at x = 8
                ok + ok + ok + [-1, 0, 8.4999]) == [
        True, False, True, False, True, True, False, True, False]
