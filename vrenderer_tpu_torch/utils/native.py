"""ctypes bindings for the native runtime library (``native/vrt_native.cpp``):
its clock and the fBm heightmap generator. (The library's scoped-event
ring serves the JAX package; the port's frame spans are recorded by
``profiler.FrameProfiler`` alone.)

On first use, ``load()`` compiles the source with the ``native/Makefile``
line (``g++ -O3 -std=c++17 -fPIC -Wall -shared``) into
``vrenderer_tpu_torch/_build/<hash>/``, keyed by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is reused. A
failed build or load raises: nothing here falls back to Python, because the
fBm path would give another heightmap.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "vrt_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
LIB_NAME = "libvrt_native.so"

_loaded: ctypes.CDLL | None = None


def _cxx() -> str:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH; the native library of "
                           "vrenderer_tpu_torch is built on first use")
    return cxx


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the source if its library is missing; returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename: test workers may build at
    # once, and none may load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [_cxx(), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the native library failed "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The built library with its C functions' signatures declared."""
    global _loaded
    if _loaded is None:
        lib = ctypes.CDLL(str(build()))
        i, u32, u64 = ctypes.c_int, ctypes.c_uint32, ctypes.c_uint64
        lib.vrt_now_ns.argtypes = []
        lib.vrt_now_ns.restype = u64
        lib.vrt_fbm_heightmap.argtypes = [
            ctypes.POINTER(ctypes.c_float), i, u32, i, ctypes.c_float]
        lib.vrt_fbm_heightmap.restype = None
        _loaded = lib
    return _loaded


def fbm_heightmap(resolution: int, seed: int = 1234, octaves: int = 8,
                  gain: float = 0.55) -> np.ndarray:
    """The native fBm value noise, (res, res) float32 in [0, 1]."""
    if resolution <= 0:
        raise ValueError(f"resolution must be positive, got {resolution}")
    out = np.zeros(resolution * resolution, np.float32)
    load().vrt_fbm_heightmap(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), resolution,
        seed, octaves, gain)
    return out.reshape(resolution, resolution)
