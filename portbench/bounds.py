"""The least time the raster kernels could take on a frame, counted from
its shapes: a frozen copy of the port's bound arithmetic (its PERF.md,
the kernel table's "Bound" column).

A raster call reads the 64-byte visibility row of every triangle of every
instance its work list holds, once, and writes its output image: 40 bytes
a pixel for the main raster (z, id and 8 attributes) and 4 for the
light view's depth-only raster. Its floor is those bytes over the card's
memory bandwidth. The operations (16 a covered (triangle, pixel) pair)
are left out: at these frames they are under 2% of the bytes' time, and
counting them needs the pairs expanded, which only the reference does.
"""

from __future__ import annotations

ROW_BYTES = 64          # 16 float32 visibility values a triangle
MAIN_PIXEL_BYTES = 40   # z, id, 8 attribute channels
DEPTH_PIXEL_BYTES = 4   # z


def raster_bytes(counts, tris_per_instance: int, width: int, height: int,
                 shadow_resolution: int, map_mode: bool) -> int:
    """Bytes one frame's raster calls must move at least: ``counts`` the
    reference's ``Counts`` of the frame."""
    main = (counts.work_instances * tris_per_instance * ROW_BYTES
            + width * height * MAIN_PIXEL_BYTES)
    if not map_mode:
        return main
    light = (counts.light_work_instances * tris_per_instance * ROW_BYTES
             + shadow_resolution * shadow_resolution * DEPTH_PIXEL_BYTES)
    return main + light


def bound_s(n_bytes: int, peaks: dict) -> float:
    return n_bytes / float(peaks["hbm_bytes_per_s"])
