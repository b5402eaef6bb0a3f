"""The raster kernels' share of their roofline, in %: the least time the
traced loop's raster calls could take (``bounds.raster_bytes`` of every
frame's work lists over the card's published bandwidth, ``peaks.json``)
over their measured device time (``raster_device_ms``)."""

from portbench import bounds
from portbench.metrics import raster_device_ms


def read(run):
    ms = raster_device_ms.read(run)
    if ms is None or run.peaks is None or not run.counts:
        return None
    cfg = run.cell.config
    traffic = run.cell.traffic
    tris = 2 * int(cfg["grid_size"]) ** 2
    frames = run.trace.frames
    n = len(run.counts)
    total = sum(bounds.raster_bytes(
        run.counts[i % n], tris, int(traffic["width"]),
        int(traffic["height"]), int(cfg["shadow_resolution"]),
        cfg["shadow_mode"] == "map") for i in range(frames))
    bound_ms = 1e3 * bounds.bound_s(total, run.peaks) / frames
    return 100.0 * bound_ms / ms
