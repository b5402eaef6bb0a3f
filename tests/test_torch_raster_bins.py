"""The binning of kernels B1, B2 and B3a through its PyTorch mirror
``raster_cuda.region_bins``: per region, its summed cost equals the pairs
the block test leaves there (``block_pair_rects``, by region); every
triangle whose bbox meets a region within a work item's supertile is
listed there once per item; the bins do not depend on the order of the
work list. On the golden frame's inputs in both item orders
(``build_work_list``, supertile-major, and ``full_work_list``,
instance-major), on random planes through block corners, on the
adversarial inputs of test_torch_raster_kernel.py, among them a hot spot
of 3000 sub-pixel triangles with tied depths; on the card, the binning
launches' per-region counts and costs (``device_bins``) equal the mirror's.

    python -m pytest tests/test_torch_raster_bins.py -q

The file imports no JAX: on the machine with the card its ``cuda`` case
runs with ``--noconftest``.
"""

import numpy as np
import pytest
import torch

from test_torch_raster_blocks import _inputs, _VIEWS
from test_torch_raster_kernel import ADVERSARIAL
from vrenderer_tpu_torch.ops import raster_cuda

# the golden views in both item orders, then the random planes and the
# adversarial inputs (each in its own work list's order)
CASES = ([f"{v}-{order}" for v in sorted(_VIEWS)
          for order in ("build", "full")] + ["random"] + list(ADVERSARIAL))


def _case(case, device="cpu"):
    """(vis, work, width, height) of a case, on ``device``."""
    name, _, order = case.partition("-")
    vis, work, w, h = _inputs(name)
    if order == "full":
        work = raster_cuda.full_work_list(vis.shape[0], w, h)
    return vis.to(device), raster_cuda.WorkList(
        items=work.items.to(device),
        num_items=work.num_items.to(device)), w, h


def _regions_x(w, side):
    return -(-w // side)


@pytest.mark.parametrize("region", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_region_cost_equals_the_block_test_pairs(case, region):
    vis, work, w, h = _case(case)
    bins = raster_cuda.region_bins(vis, work, w, h, region=region)
    side = bins.side
    rects = raster_cuda.block_pair_rects(vis, work, w, h, region=region)
    n_regions = _regions_x(w, side) * -(-h // side)
    at = rects.y0 // side * _regions_x(w, side) + rects.x0 // side
    want = torch.zeros(n_regions, dtype=torch.long).index_add_(0, at,
                                                               rects.cnt)
    assert torch.equal(bins.region_cost, want)
    assert int(bins.cost.sum()) == int(rects.cnt.sum()) > 0
    # the entries' costs sum to their region's
    per = torch.zeros(n_regions, dtype=torch.long)
    counts = bins.start[1:] - bins.start[:-1]
    per.index_add_(0, torch.repeat_interleave(
        torch.arange(n_regions), counts), bins.cost)
    assert torch.equal(per, want)
    assert bool((bins.cost >= 0).all())


def _meeting(vis, items, w, h, side, tile=128):
    """Sorted (region, gid) of every triangle whose bbox holds a pixel of a
    region of an item's supertile, once per item, by pixel coordinates in
    float64 numpy."""
    vis = vis.numpy().astype(np.float64)
    T = vis.shape[1]
    tiles_x = -(-w // tile)
    n_st = tiles_x * -(-h // tile)
    k = tile // side
    rx = _regions_x(w, side)
    out = []
    for inst, st in items.numpy():
        if inst < 0 or not 0 <= st < n_st:
            continue
        bb = vis[inst, :, 12:16]
        for s in range(k * k):
            x0 = st % tiles_x * tile + s % k * side
            y0 = st // tiles_x * tile + s // k * side
            if x0 >= w or y0 >= h:
                continue
            x1, y1 = min(x0 + side, w) - 1, min(y0 + side, h) - 1
            with np.errstate(invalid="ignore"):
                px0 = np.maximum(np.ceil(bb[:, 0]), x0)
                px1 = np.minimum(np.floor(bb[:, 2]), x1)
                py0 = np.maximum(np.ceil(bb[:, 1]), y0)
                py1 = np.minimum(np.floor(bb[:, 3]), y1)
                meet = (px0 <= px1) & (py0 <= py1)
            region = y0 // side * rx + x0 // side
            out += [(region, inst * T + t) for t in np.nonzero(meet)[0]]
    return sorted(out)


@pytest.mark.parametrize("case", CASES)
def test_every_triangle_meeting_a_region_is_listed_there_once(case):
    vis, work, w, h = _case(case)
    bins = raster_cuda.region_bins(vis, work, w, h)
    counts = (bins.start[1:] - bins.start[:-1]).tolist()
    region = np.repeat(np.arange(len(counts)), counts)
    got = sorted(zip(region.tolist(), bins.gid.tolist()))
    assert got == _meeting(vis, work.items, w, h, bins.side)
    assert len(got) > 0


def test_bins_do_not_depend_on_the_item_order():
    """The golden front view's work list reversed, with unused slots and
    an item outside the frame among its items: every region lists the same
    (gid, cost) entries."""
    vis, work, w, h = _case("front-build")
    items = work.items[work.items[:, 0] >= 0].flip(0)
    junk = torch.tensor([[-1, -1], [-1, 0], [0, 99]], dtype=torch.int32)
    shuffled = raster_cuda.WorkList(
        items=torch.cat([junk[:1], items[:5], junk[1:], items[5:]]),
        num_items=work.num_items)
    a = raster_cuda.region_bins(vis, work, w, h)
    b = raster_cuda.region_bins(vis, shuffled, w, h)
    assert torch.equal(a.start, b.start)
    assert torch.equal(a.region_cost, b.region_cost)
    for r in range(a.start.numel() - 1):
        sl = slice(int(a.start[r]), int(a.start[r + 1]))
        key_a = sorted(zip(a.gid[sl].tolist(), a.cost[sl].tolist()))
        key_b = sorted(zip(b.gid[sl].tolist(), b.cost[sl].tolist()))
        assert key_a == key_b


def test_hot_spot_piles_into_one_region():
    """The hot spot's 3000 triangles and its floor all land in the region
    of their spot, which then holds all but the floor's other pairs."""
    vis, work, w, h = _case("hot_spot")
    bins = raster_cuda.region_bins(vis, work, w, h)
    counts = bins.start[1:] - bins.start[:-1]
    busiest = int(torch.argmax(bins.region_cost))
    assert int(counts[busiest]) == 3001
    spot = bins.region_cost[busiest] - 64 * 64        # less the floor
    assert 3000 <= int(spot) <= 3000 * 9


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["front-build", "side-full", "random",
                                  "crossing", "instance_major", "hot_spot"])
def test_cuda_binning_matches_the_mirror(case):
    """The card's binning launches count each region's entries and cost as
    ``region_bins`` does, for B1's and B2's scratch, and split each
    region into ceil(cost / CHUNK) chunks, at least one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    vis, work, w, h = _case(case)
    want = raster_cuda.region_bins(vis, work, w, h)
    counts = want.start[1:] - want.start[:-1]
    chunks = torch.clamp(-(-want.region_cost // raster_cuda.CHUNK), min=1)
    vis_c, work_c, _, _ = _case(case, "cuda")
    for key_bytes in (8, 4):
        got = raster_cuda.device_bins(vis_c, work_c, w, h,
                                      key_bytes=key_bytes)
        assert torch.equal(got.entries.cpu(), counts)
        assert torch.equal(got.cost.cpu(), want.region_cost)
        assert torch.equal(got.chunks.cpu(), chunks)
