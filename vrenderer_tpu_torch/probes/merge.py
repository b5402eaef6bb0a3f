"""P3: B1's merge alone. The counterpart of scripts/probe_transposed.py
(``kernel``: per pixel the minimum over k of x[p, 0] * x[0, k] + x[p, k]
for (2048, 128) float32; ``transpose_kernel``: the (128, 16) -> (16, 128)
finalize relayout); kernel ``vrt_probe_merge`` of csrc/probes.cu.

Pixels are x-major, p = col * rows + row; each gets the smallest
e = fl(fl(x[p, 0] * x[0, k]) + x[p, k]) and the lowest k that gives it,
returned row-major (rows, cols). Three merges, as ``VARIANTS`` names them:
B1's 64-bit (z, id) shared atomicMin, a 32-bit z atomicMin and an id pass
(B2's native atomic), and owner threads without atomics. Two inputs:
the probe's own (2048 pixels, 128 candidates) and a hot spot (a 64 x 64
region with 4096 candidates each, as the light pass piles its triangles).
Beside them, the one PyTorch call that computes the same merge
(``merge_library``: ``scatter_reduce_`` with "amin" over int64 keys) is
checked and timed.
"""

from __future__ import annotations

import numpy as np
import torch

from vrenderer_tpu_torch.ops import _build
from vrenderer_tpu_torch.probes import common

VARIANTS = ("packed64", "z_then_id", "owner")
# (pixels, candidates, rows): probe_transposed's (16 x 128 px) and the hot
# spot's 64 x 64 px
PATTERNS = {"probe": (2048, 128, 16), "hotspot": (4096, 4096, 64)}
PAIR_OPS = 2      # one multiply, one add a (pixel, candidate) pair


def merge_input(pixels: int, cands: int, seed: int = 0,
                device=None) -> torch.Tensor:
    """x (pixels, cands) uniform in [0, 1) from ``seed``; (2048, 128) of
    seed 0 is probe_transposed's input."""
    x = np.random.default_rng(seed).random((pixels, cands), np.float32)
    return torch.as_tensor(x, device=device)


def merge(x: torch.Tensor, rows: int, variant: str, regions: int = 1):
    """(z, id) (regions, rows, P // rows): each region merges all of x.
    CUDA tensors launch the kernel, CPU tensors run ``merge_plain``."""
    P, Kc = x.shape
    if x.device.type == "cpu":
        z, i = merge_plain(x, rows)
        return (z.expand(regions, -1, -1).clone(),
                i.expand(regions, -1, -1).clone())
    common.check(x, (P, Kc), torch.float32, x.device, "merge input")
    z = torch.empty((regions, rows, P // rows), dtype=torch.float32,
                    device=x.device)
    ids = torch.empty((regions, rows, P // rows), dtype=torch.int32,
                      device=x.device)
    _build.launch("vrt_probe_merge", x.device, x.data_ptr(), P, Kc, rows,
                  regions, VARIANTS.index(variant), z.data_ptr(),
                  ids.data_ptr())
    merge.launches += 1
    return z, ids


merge.launches = 0


def merge_plain(x: torch.Tensor, rows: int):
    """The kernel's function in PyTorch: (z, id) (rows, P // rows)."""
    e = x[:, 0:1] * x[0:1, :] + x + 0.0          # -0.0 made +0.0
    z = torch.amin(e, dim=1)
    ids = torch.argmin(e, dim=1)                  # the first: the lowest k
    return finalize(z, rows), finalize(ids.to(torch.int32), rows)


def merge_library(x: torch.Tensor, rows: int, regions: int):
    """The merge as one PyTorch call, timed beside the kernel and used
    nowhere in the port: ``Tensor.scatter_reduce_(0, pixel, key, "amin",
    include_self=True)`` over every region's pairs, each key an int64 (z
    bits, k) (z >= +0.0, so its bits order as z). Returns (the call, (z,
    id) (regions, rows, P // rows) of its result)."""
    P, Kc = x.shape
    dev = x.device
    e = x[:, 0:1] * x[0:1, :] + x + 0.0
    key = ((e.view(torch.int32).long() << 32)
           | torch.arange(Kc, device=dev)).reshape(1, -1)
    key = key.expand(regions, -1).reshape(-1)
    pixel = (torch.arange(regions, device=dev)[:, None] * P
             + torch.arange(P, device=dev).repeat_interleave(Kc)[None, :]
             ).reshape(-1)
    out = torch.full((regions * P,), torch.iinfo(torch.int64).max,
                     dtype=torch.int64, device=dev)

    def call():
        return out.scatter_reduce_(0, pixel, key, "amin", include_self=True)

    call()
    z = (out >> 32).to(torch.int32).view(torch.float32).reshape(regions, P)
    ids = (out & 0xFFFFFFFF).to(torch.int32).reshape(regions, P)
    return call, (torch.stack([finalize(v, rows) for v in z]),
                  torch.stack([finalize(v, rows) for v in ids]))


def finalize(v: torch.Tensor, rows: int) -> torch.Tensor:
    """x-major pixel values (P,) -> row-major (rows, P // rows)."""
    return v.reshape(-1, rows).T.contiguous()


def run(device, small: bool = False) -> dict:
    """Each variant at each pattern against the plain version (z and id bit
    for bit), on one region a streaming multiprocessor; times and merged
    pairs a second on the card."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    regions = (torch.cuda.get_device_properties(device).multi_processor_count
               if on_card else 2)
    patterns = ({"probe": (256, 32, 16), "hotspot": (256, 256, 16)} if small
                else PATTERNS)
    res = {"regions": regions}
    for pat, (pixels, cands, rows) in patterns.items():
        x = merge_input(pixels, cands, device=device)
        zw, iw = merge_plain(x, rows)
        pairs = regions * pixels * cands
        # the library call's function checked, then timed on the card (its
        # keys and pixel indices take 16 bytes a pair)
        lib, (zl, il) = merge_library(x, rows, regions)
        if not (common.bits_equal(zl, zw.expand_as(zl).contiguous())
                and common.bits_equal(il, iw.expand_as(il).contiguous())):
            raise RuntimeError(f"P3 scatter_reduce_ at {pat}: differs from "
                               f"the plain version")
        library_ms = common.cuda_ms(lib, 5) if on_card else None
        del lib, zl, il
        if on_card:
            torch.cuda.empty_cache()
        # the plain version merges each region's pairs as the kernel does
        plain_ms = (common.cuda_ms(lambda: [merge_plain(x, rows)
                                            for _ in range(regions)], 1,
                                   queued=False) if on_card else None)
        for v in VARIANTS:
            z, ids = merge(x, rows, v, regions)
            if not (common.bits_equal(z, zw.expand_as(z).contiguous())
                    and common.bits_equal(ids, iw.expand_as(ids)
                                          .contiguous())):
                raise RuntimeError(f"P3 {v} at {pat}: differs from the plain "
                                   f"version")
            # each region merges all pairs of x (L2-resident after the
            # first read) and writes its z and id once
            row = {"pairs": pairs, "plain_ms": plain_ms,
                   "max_abs_err": float((z - zw).abs().max()),
                   "library_ms": library_ms,
                   **common.bound(x.numel() * 4 + regions * pixels * 8,
                                  pairs * PAIR_OPS)}
            if on_card:
                ms = common.cuda_ms(lambda v=v: merge(x, rows, v, regions),
                                    20)
                row.update(ms=ms, g_pairs_s=pairs / ms * 1e-6)
            res[f"{pat}_{v}"] = row
    if on_card:
        res["sass"] = common.sass_ops(r"merge_kernel", r"ATOMS\.[A-Z0-9.]+")
    return res
