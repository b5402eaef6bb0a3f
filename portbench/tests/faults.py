"""A dry run of the benchmark with the timed path broken underneath, for
``test_portbench_control.py``:

    python -m portbench.tests.faults <fault> <workload> <seed>

patches the program in this process, then runs ``run.main`` on the CPU;
the last line of its output is the run's result. Each fault is one that a
frame loop can have:

* ``stale_state``: eye adaptation returns its carry unchanged;
* ``half_batch``: half of each frame's work items are left out of the
  raster (the count still says all);
* ``altered_pixel``: one pixel of every frame's sRGB image is off by
  one 8-bit step where the image is produced;
* ``altered_count``: each frame's work-item count is one too many.
"""

from __future__ import annotations

import sys


def apply(fault: str) -> None:
    import torch
    from vrenderer_tpu_torch.ops import lighting, raster_cuda

    if fault == "stale_state":
        def adapt_exposure(hdr, covered, adapted_lum, dt, **kw):
            return adapted_lum, 0.5 / adapted_lum

        lighting.adapt_exposure = adapt_exposure
    elif fault in ("half_batch", "altered_count"):
        build = raster_cuda.build_work_list

        def build_work_list(*a, **kw):
            work = build(*a, **kw)
            if fault == "altered_count":
                return work._replace(num_items=work.num_items + 1)
            items = work.items.clone()
            items[1::2] = -1
            return work._replace(items=items)

        raster_cuda.build_work_list = build_work_list
    elif fault == "altered_pixel":
        encode = lighting.srgb_encode

        def srgb_encode(linear):
            out = encode(linear).clone()
            out[0, 0] += torch.where(out[0, 0] > 0.5, -1.0, 1.0) / 255.0
            return out

        lighting.srgb_encode = srgb_encode
    else:
        raise ValueError(f"unknown fault {fault!r}")


if __name__ == "__main__":
    from portbench import run

    fault, workload, seed = sys.argv[1:4]
    apply(fault)
    sys.exit(run.main(["--workload", workload, "--seed", seed,
                       "--seconds", "0", "--trace", "0", "--dry-run"]))
