"""The raster kernels' device time a frame, in ms: every launch of
``csrc/raster.cu``'s binning passes (``bins_*``), its raster launch
(``raster_kernel``) and B1's finish (``finish_kernel``) in the traced
loop, by name, over its frames (B1, and B2 in map cells)."""

import re

RASTER = re.compile(r"\b(bins_\w+|raster_kernel|finish_kernel)\b")


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    s = sum(v for k, v in t.seconds_by_name().items() if RASTER.search(k))
    if s <= 0:
        return None
    return 1e3 * s / t.frames
