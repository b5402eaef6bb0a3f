"""Heightmap and albedo assets, and a PNG reader.

The same numpy construction as ``vrenderer_tpu.terrain.heightmap`` (value
noise fBm with a dome falloff, quantized like an 8-bit PNG), so the arrays
are bit-equal; they are returned as float32 tensors on ``device``. From
1024 texels a side the fBm comes from the native library
(``utils/native.py``), as in the JAX package. ``load_png`` decodes with
``zlib`` alone, so it needs no imaging library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _smoothstep(t: np.ndarray) -> np.ndarray:
    return t * t * (3.0 - 2.0 * t)


def _value_noise(res: int, cells: int, rng: np.random.Generator) -> np.ndarray:
    """One octave of value noise on a res x res grid."""
    lattice = rng.random((cells + 1, cells + 1), dtype=np.float32)
    u = np.linspace(0.0, cells, res, endpoint=False, dtype=np.float32)
    i0 = np.floor(u).astype(np.int32)
    f = _smoothstep(u - i0)
    i1 = np.minimum(i0 + 1, cells)
    rows = (
        lattice[i0][:, i0] * (1 - f)[None, :] + lattice[i0][:, i1] * f[None, :]
    )
    rows1 = (
        lattice[i1][:, i0] * (1 - f)[None, :] + lattice[i1][:, i1] * f[None, :]
    )
    return rows * (1 - f)[:, None] + rows1 * f[:, None]


def procedural_heightmap(resolution: int = 256, seed: int = 1234,
                         device=None) -> torch.Tensor:
    """Deterministic fBm heightfield in [0, 1], (res, res) float32, indexed
    [v, u] = [z row, x column] (terrain_vs.hlsl:30)."""
    if resolution >= 1024:
        # large fields: the fBm loop runs in the native library (its own
        # lattice hash); the shaping below is the same on both paths
        from vrenderer_tpu_torch.utils import native

        h = native.fbm_heightmap(resolution, seed=seed, octaves=32,
                                 gain=0.55)
    else:
        rng = np.random.default_rng(seed)
        h = np.zeros((resolution, resolution), np.float32)
        amp, cells, total = 1.0, 4, 0.0
        while cells <= resolution // 2:
            h += amp * _value_noise(resolution, cells, rng)
            total += amp
            amp *= 0.55
            cells *= 2
        h = h / total
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, resolution, dtype=np.float32),
        np.linspace(-1, 1, resolution, dtype=np.float32),
        indexing="ij",
    )
    dome = np.clip(1.0 - 0.55 * (xx * xx + yy * yy), 0.0, 1.0)
    h = np.clip(h * (0.35 + 0.65 * dome), 0.0, 1.0)
    h = np.round(h * 255.0) / 255.0
    return torch.as_tensor(h.astype(np.float32), device=device)


def procedural_albedo(height01: torch.Tensor) -> torch.Tensor:
    """Grass -> rock -> snow albedo ramp (res, res, 3) from the height
    field, on the height field's device."""
    h = height01.detach().cpu().numpy()
    grass = np.array([0.13, 0.35, 0.11], np.float32)
    rock = np.array([0.35, 0.30, 0.26], np.float32)
    snow = np.array([0.85, 0.87, 0.90], np.float32)
    t1 = np.clip((h - 0.25) / 0.35, 0.0, 1.0)[..., None]
    t2 = np.clip((h - 0.65) / 0.2, 0.0, 1.0)[..., None]
    c = grass * (1 - t1) + rock * t1
    c = c * (1 - t2) + snow * t2
    return torch.as_tensor(c.astype(np.float32), device=height01.device)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # gray, RGB, gray+alpha, RGBA


def _unfilter(data: bytes, height: int, width: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters 0-4 (None, Sub, Up, Average, Paeth) of
    8-bit samples: (height, width * bpp) uint8."""
    stride = width * bpp
    if len(data) != height * (stride + 1):
        raise ValueError(f"PNG image data holds {len(data)} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, raw = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = raw.copy()
        elif kind == 1:
            # Sub is a running sum per channel, modulo 256
            cur = (np.cumsum(raw.reshape(width, bpp), axis=0, dtype=np.int64)
                   % 256).astype(np.uint8).reshape(stride)
        elif kind == 2:
            cur = raw + prev
        elif kind in (3, 4):
            # each byte depends on the decoded byte to its left
            cur = bytearray(raw.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def load_png(path: str, device=None) -> torch.Tensor:
    """An 8-bit, non-interlaced PNG (gray, gray+alpha, RGB or RGBA) as
    float32 in [0, 1] on ``device``: (H, W) for gray, else (H, W, C), the
    layout of the JAX package's pillow reader. Other PNGs raise."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        crc = blob[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated {tag!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + body):
            raise ValueError(f"{path}: CRC mismatch in {tag!r} chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: bit depth {depth}, color type {color}, interlace "
            f"{interlace}; only 8-bit non-interlaced gray, gray+alpha, RGB "
            f"and RGBA are read")
    ch = _PNG_CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), height, width, ch)
    img = px.reshape(height, width, ch) if ch > 1 else px
    return torch.as_tensor(img.astype(np.float32) / np.float32(255.0),
                           device=device)
