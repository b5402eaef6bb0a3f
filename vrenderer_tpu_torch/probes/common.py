"""What the probes share (and ``chip_smoke.py`` uses): CUDA-event timing,
the card's peaks and the bound, input checks and the SASS reading.
"""

from __future__ import annotations

import re
import subprocess
from collections import Counter
from pathlib import Path

import torch

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s and
# float32 operations/s outside the tensor cores (an FMA counts 2)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def check(x: torch.Tensor, shape, dtype, device: torch.device, what: str):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if (tuple(x.shape) != tuple(shape) or x.dtype != dtype
            or x.device != device or not x.is_contiguous()):
        raise ValueError(f"{what}: {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"expected contiguous {tuple(shape)} {dtype} on "
                         f"{device}")


def cuda_ms(fn, reps: int, queued: bool = True) -> float:
    """Mean milliseconds of ``fn`` on the current stream (CUDA events).
    ``queued``: the reps queue behind a device-side sleep, lengthened until
    the host has queued them all before it ends, so the time is the
    device's, not the host's launch rate. Plain versions run unqueued."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()   # the device still sleeps
        end.synchronize()
        if ahead or not queued:
            return start.elapsed_time(end) / reps
        if cycles >= 1 << 32:
            raise RuntimeError("the host could not queue the reps ahead of "
                               "the device")
        cycles *= 4


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    float32 operations over the peak rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, types and bits (floats as integers: -0.0 and NaN
    payloads count)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b.to(a.device)))


def sass_ops(pattern: str, ops: str) -> dict:
    """Per kernel of the built library whose mangled name matches
    ``pattern``, the count of each SASS instruction matching ``ops`` (a
    regex), from cuobjdump."""
    from vrenderer_tpu_torch.ops import _build

    lib = _build.build()
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        raise RuntimeError(f"{tool} not found")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    per_fn, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = fn if re.search(pattern, fn) else None
        elif name:
            for op in re.findall(r"\b(" + ops + r")\b", line):
                per_fn.setdefault(name, Counter())[op] += 1
    return {k: dict(v) for k, v in per_fn.items()}
