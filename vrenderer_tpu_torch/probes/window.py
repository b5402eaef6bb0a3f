"""P4: B3b's coefficient gather alone. The counterpart of
scripts/probe_window.py (``kern_a``, ``kern_b``, ``kern_c``: a 512-column
window of (48, 2048) float32 at scalar-prefetched starts, contracted with a
one-hot that sums groups of 16 columns); kernel ``vrt_probe_window`` of
csrc/probes.cu.

out[s, j, c] = the sum, in ascending order, of data[c, start_s + j*g + i]
over i < g: windows of W floats at runtime starts, in groups of g. Two
inputs: probe_window's (C 48, T 2048, W 512, g 16, starts 0, 128, 640,
1536) and B1's output pass (C 1, W 27, g 1: each covered pixel's winner's
27 plane coefficients, starts id * 27, at the 1920x1152 horizon frame's
camera 13). Two loads, as ``VARIANTS`` names them: scalar, or the aligned
float4s around the window and a shift in registers (``load_coef``).
"""

from __future__ import annotations

import numpy as np
import torch

from vrenderer_tpu_torch.ops import _build
from vrenderer_tpu_torch.probes import common

VARIANTS = ("scalar", "float4")
C, T, W, G = 48, 2048, 512, 16          # probe_window's sizes
STARTS = (0, 128, 640, 1536)
COEF_W = 27                             # a triangle's plane coefficients
COEF_CAMERA = 13                        # the horizon frame's grazing view


def window_input(seed: int = 0, device=None) -> torch.Tensor:
    """probe_window's data (48, 2048), normal from ``seed``."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((C, T)).astype(np.float32),
                           device=device)


def coef_input(device, small: bool = False):
    """(data (1, n * 27), starts (S,) int32): B1's coefficients and the
    covered pixels' winners at the 1920x1152 horizon frame's camera 13
    (``workloads.build("1080p")``); ``small``: 64 random triangles and 500
    random winners."""
    if small:
        rng = np.random.default_rng(0)
        coef = rng.standard_normal((1, 64 * COEF_W)).astype(np.float32)
        ids = rng.integers(0, 64, 500).astype(np.int32)
        return (torch.as_tensor(coef, device=device),
                torch.as_tensor(ids * COEF_W, device=device))
    from vrenderer_tpu_torch import workloads
    from vrenderer_tpu_torch.ops import raster_cuda

    r, params, cams = workloads.build("1080p", device)
    cfg = r.config
    packed, work = r.raster_inputs(cams.frame(COEF_CAMERA), params,
                                   r.cached_horizon_prepass(params))
    _, ids, _ = raster_cuda.rasterize(packed, work, cfg.width, cfg.height,
                                      cfg.raster.tile_w)
    starts = (ids[ids >= 0] * COEF_W).to(torch.int32)
    return packed.coef.reshape(1, -1), starts.contiguous()


def window(data: torch.Tensor, starts: torch.Tensor, w: int, g: int,
           variant: str) -> torch.Tensor:
    """(S, w // g, C) group sums of each window. CUDA tensors launch the
    kernel, CPU tensors run ``window_plain``."""
    if data.device.type == "cpu":
        return window_plain(data, starts, w, g)
    c, t = data.shape
    common.check(data, (c, t), torch.float32, data.device, "window rows")
    common.check(starts, starts.shape, torch.int32, data.device,
                 "window starts")
    out = torch.empty((starts.shape[0], w // g, c), dtype=torch.float32,
                      device=data.device)
    _build.launch("vrt_probe_window", data.device, data.data_ptr(), c, t,
                  starts.data_ptr(), starts.shape[0], w, g,
                  16 if g == 16 else COEF_W, VARIANTS.index(variant),
                  out.data_ptr())
    window.launches += 1
    return out


window.launches = 0


def window_plain(data: torch.Tensor, starts: torch.Tensor, w: int,
                 g: int) -> torch.Tensor:
    """The kernel's function in PyTorch."""
    c, t = data.shape
    if int(starts.min()) < 0 or int(starts.max()) > t - w:
        raise ValueError(f"window starts outside [0, {t - w}]")
    idx = starts.long()[:, None] + torch.arange(w, device=data.device)
    win = data[:, idx].permute(1, 2, 0).reshape(-1, w // g, g, c)
    acc = win[:, :, 0]
    for i in range(1, g):
        acc = acc + win[:, :, i]
    return acc


def run(device, small: bool = False) -> dict:
    """Both variants at both inputs against the plain version (bit for
    bit); times and rates on the card."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    cases = {
        "window": (window_input(device=device),
                   torch.tensor(STARTS, dtype=torch.int32, device=device),
                   W, G),
        "coef": (*coef_input(device, small), COEF_W, 1),
    }
    res = {}
    for name, (data, starts, w, g) in cases.items():
        want = window_plain(data, starts, w, g)
        s = starts.shape[0]
        # bytes: the distinct windows' floats read once, starts, the output
        rows_read = torch.unique(starts).numel() * data.shape[0] * w * 4
        n_bytes = rows_read + s * 4 + want.numel() * 4
        ops = s * data.shape[0] * (w - w // g)
        plain_ms = (common.cuda_ms(lambda: window_plain(data, starts, w, g),
                                   1, queued=False) if on_card else None)
        # one PyTorch call computing the gather from the winner ids:
        # embedding rows of the coefficient table
        library_ms = None
        if on_card and name == "coef":
            ids, table = starts.long() // w, data.reshape(-1, w)
            library_ms = common.cuda_ms(
                lambda: torch.nn.functional.embedding(ids, table), 20)
        for v in VARIANTS:
            got = window(data, starts, w, g, v)
            if not common.bits_equal(got, want):
                raise RuntimeError(f"P4 {v} at {name}: differs from the plain "
                                   f"version")
            row = {"windows": s, "bytes": n_bytes, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "max_abs_err": float((got - want).abs().max()),
                   **common.bound(n_bytes, ops)}
            if on_card:
                ms = common.cuda_ms(lambda v=v: window(data, starts, w, g, v),
                                    20)
                row.update(ms=ms, gb_s=n_bytes / ms * 1e-6)
            res[f"{name}_{v}"] = row
    return res
