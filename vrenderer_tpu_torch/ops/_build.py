"""Builds the package's CUDA sources and loads them with ctypes.

On first use, ``load()`` runs ``nvcc`` on ``vrenderer_tpu_torch/csrc/*.cu``
(the rasterizer, ``raster.cu``, the quadtree selection, ``select.cu``, the
triangle setup, ``setup.cu``, and the microbenchmarks, ``probes.cu``)
into one shared library with a plain C interface under
``vrenderer_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused. The
compiler's output (``-Xptxas -v``: registers, shared memory, spills per
kernel) is kept beside the library in ``nvcc.log``. Nothing is fetched:
``nvcc`` comes from ``$CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # the rasterizer's plane evaluations must not contract into FMA; the
    # probes spell out each FMA they time (__fmaf_rn)
    "--fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
LIB_NAME = "libvrt_kernels.so"

_loaded: ctypes.CDLL | None = None


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "vrenderer_tpu_torch are built on the machine with the "
                       "card")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the sources if their library is missing; returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename, so a concurrent or cut build
    # never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (lib.parent / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The built library with its C functions' signatures declared."""
    global _loaded
    if _loaded is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll = ctypes.c_longlong
        lib.vrt_raster.argtypes = [p, p, p, i, i, i, i, i, i, i, i, f, p,
                                   ll, p, p, p, p]
        lib.vrt_raster_zid.argtypes = [p, p, i, i, i, i, i, i, i, i, p, ll,
                                       p, p, p]
        lib.vrt_raster_bins.argtypes = [p, p, i, i, i, i, i, i, i, i, p, ll,
                                        p]
        lib.vrt_raster_scratch.argtypes = [i, i, i, i, i, i, i, i,
                                           ctypes.POINTER(ll)]
        lib.vrt_raster_scratch.restype = ll
        lib.vrt_raster_gather.argtypes = [p, p, i, p, p]
        lib.vrt_raster_resolve.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                                           i, i, p, p, p]
        lib.vrt_filter_winners.argtypes = [p, i, p, i, i, i, i, i, i, i, p,
                                           p, p]
        lib.vrt_raster_depth.argtypes = [p, p, i, i, i, i, i, i, i, p, ll,
                                         p, p]
        lib.vrt_select.argtypes = [p, p, p, i, i, i, i, i, p, p, p, p, p, p,
                                   p, p, p]
        lib.vrt_setup.argtypes = [p, p, i, p, p, i, i, i, i, p, i, i, f, i,
                                  f, p, p, p, p, p, p]
        lib.vrt_probe_sweep.argtypes = [p, p, p, i, i, i, i, f, f, p]
        lib.vrt_probe_eval.argtypes = [p, p, i, i, i, i, i, i, p, i, p, p, p,
                                       p]
        lib.vrt_probe_merge.argtypes = [p, i, i, i, i, i, p, p, p]
        lib.vrt_probe_window.argtypes = [p, i, i, p, i, i, i, i, i, p, p]
        for fn in (lib.vrt_raster, lib.vrt_raster_zid, lib.vrt_raster_bins,
                   lib.vrt_raster_gather,
                   lib.vrt_raster_resolve, lib.vrt_filter_winners,
                   lib.vrt_raster_depth, lib.vrt_select, lib.vrt_setup,
                   lib.vrt_probe_sweep, lib.vrt_probe_eval,
                   lib.vrt_probe_merge, lib.vrt_probe_window):
            fn.restype = i
        _loaded = lib
    return _loaded


def launch(entry: str, device, *args) -> None:
    """Call the library's ``entry`` with ``args`` and the current stream of
    ``device``, a CUDA device; raise if the launch failed (the C function
    returns the CUDA error code)."""
    import torch

    if device.type != "cuda":
        raise ValueError(f"{entry} runs on a CUDA device, not {device}")
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
