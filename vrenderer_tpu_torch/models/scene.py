"""Scene: mesh instances, a directional light (Renderer.cpp:101-147) and
a glTF 2.0 loader, as in ``vrenderer_tpu.models.scene``.

``Scene.default()`` is the boot scene (the Cube.gltf analog,
main.cpp:89-95). ``load_gltf`` reads .gltf (data-URI or external buffers)
and .glb files of triangle meshes: POSITION, NORMAL, COLOR_0, indices,
the node hierarchy and the material's base colour, whose PNG texture is
baked to vertex colours after ``subdivide_to_texel_density``. Load-time
work is host numpy with the JAX package's operations in its order, so
both packages load the same arrays; the meshes land on ``device``.
"""

from __future__ import annotations

import base64
import json
import os
import struct
import warnings
import zlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from vrenderer_tpu_torch.config import LightParams
from vrenderer_tpu_torch.models.mesh import (
    Mesh, cube, subdivide_to_texel_density,
)
from vrenderer_tpu_torch.terrain.heightmap import _unfilter
from vrenderer_tpu_torch.utils import math3d


@dataclass
class MeshInstance:
    mesh: Mesh
    transform: torch.Tensor  # (4, 3) row-vector affine
    name: str = ""


@dataclass
class Scene:
    instances: List[MeshInstance] = field(default_factory=list)
    light: Optional[LightParams] = None

    @staticmethod
    def default(device=None) -> "Scene":
        """One 40 m cube at (0, 120, 0) and the reference's default sun
        (Renderer.cpp:135-142)."""
        return Scene(
            instances=[MeshInstance(
                mesh=cube(40.0, color=(0.8, 0.2, 0.2), device=device),
                transform=math3d.affine_translation(torch.tensor(
                    [0.0, 120.0, 0.0], dtype=torch.float32, device=device)),
                name="Cube",
            )],
            light=LightParams(),
        )

    def ensure_light(self) -> LightParams:
        """SceneLoaded(): attach the default sun if the scene has none
        (Renderer.cpp:133)."""
        if self.light is None:
            self.light = LightParams()
        return self.light


# ---------------------------------------------------------------------------
# glTF 2.0 loading (triangle meshes)
# ---------------------------------------------------------------------------

_COMPONENT = {
    5120: ("b", 1), 5121: ("B", 1), 5122: ("h", 2),
    5123: ("H", 2), 5125: ("I", 4), 5126: ("f", 4),
}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _read_accessor(gltf: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    """Accessor ``idx`` as (count, components) float64; normalized integer
    components are divided by their type's maximum."""
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    buf = buffers[view.get("buffer", 0)]
    fmt, csize = _COMPONENT[acc["componentType"]]
    ncomp = _NCOMP[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", csize * ncomp)
    out = np.empty((count, ncomp), np.float64)
    for i in range(count):
        out[i] = struct.unpack_from(f"<{ncomp}{fmt}", buf, offset + i * stride)
    if acc.get("normalized"):
        out /= float(2 ** (8 * csize) - 1)
    return out


def _decode_png(data: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced gray, gray+alpha, RGB or RGBA PNG as
    (H, W, 3) float32 in [0, 1]: gray is repeated, gray+alpha keeps its
    gray, alpha is dropped. It checks what the JAX package's decoder
    checks and no more (no CRC), and like it takes a row filter byte above
    4 as Paeth; other PNGs raise."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG")
    off, idat, header = 8, b"", None
    while off < len(data):
        (clen,) = struct.unpack_from(">I", data, off)
        tag = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + clen]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        off += 12 + clen
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace != 0:
        raise ValueError(f"bit depth {depth}, interlace {interlace}: only "
                         f"8-bit non-interlaced PNGs are read")
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = rows[:h * (w * nch + 1)].reshape(h, w * nch + 1).copy()
    rows[:, 0] = np.minimum(rows[:, 0], 4)
    img = (_unfilter(rows.tobytes(), h, w, nch).reshape(h, w, nch)
           .astype(np.float32) / 255.0)
    if nch == 1:
        return np.repeat(img, 3, axis=-1)
    if nch == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def _sample_bilinear(img: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Bilinear samples of (H, W, 3) at (N, 2) uv with wrap addressing
    (glTF's default sampler), where an exact upper edge (u = 1, 2, ...)
    stays at 1.0 instead of wrapping to the left texel. Load-time numpy."""
    H, W = img.shape[:2]

    def wrap(x):
        f = x - np.floor(x)
        return np.where((x != 0.0) & (f == 0.0), 1.0, f)

    u = wrap(uv[:, 0]) * (W - 1)
    v = wrap(uv[:, 1]) * (H - 1)
    x0 = np.floor(u).astype(np.int64)
    y0 = np.floor(v).astype(np.int64)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx = (u - x0)[:, None]
    fy = (v - y0)[:, None]
    a = img[y0, x0]
    b = img[y0, x1]
    c = img[y1, x0]
    d = img[y1, x1]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


def _node_transform(node: dict) -> np.ndarray:
    """A glTF node's local transform as a (4, 3) row-vector affine float32:
    its column-major ``matrix``, or v' = (v * scale) @ R(rotation) +
    translation."""
    if "matrix" in node:
        m = np.asarray(node["matrix"], np.float32).reshape(4, 4).T
        lin = m[:3, :3].T
        tr = m[:3, 3]
        return np.concatenate([lin, tr[None, :]], axis=0).astype(np.float32)
    t = np.asarray(node.get("translation", [0, 0, 0]), np.float32)
    s = np.asarray(node.get("scale", [1, 1, 1]), np.float32)
    x, y, z, w = np.asarray(node.get("rotation", [0, 0, 0, 1]), np.float32)
    rot = np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w)],
        [2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w)],
        [2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    lin = np.diag(s) @ rot
    return np.concatenate([lin, t[None, :]], axis=0).astype(np.float32)


def _read_file(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _read_glb(raw: bytes):
    """(json, [binary chunks]) of a GLB container."""
    magic, _, _ = struct.unpack_from("<III", raw, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    off, gltf, buffers = 12, None, []
    while off < len(raw):
        clen, ctype = struct.unpack_from("<II", raw, off)
        data = raw[off + 8:off + 8 + clen]
        if ctype == 0x4E4F534A:      # JSON
            gltf = json.loads(data)
        elif ctype == 0x004E4942:    # BIN
            buffers.append(data)
        off += 8 + clen
    if gltf is None:
        raise ValueError("GLB file without a JSON chunk")
    return gltf, buffers


def _uri_bytes(uri: str, base_dir: str) -> bytes:
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    return _read_file(os.path.join(base_dir, uri))


def load_gltf(path: str, texture_subdiv_texels: float = 1.0,
              max_subdiv_tris: int = 1 << 18, device=None) -> Scene:
    """Load a .gltf or .glb file of triangle meshes into a Scene on
    ``device``, one MeshInstance per (node, primitive).

    A primitive's colour is its material's baseColorFactor (0.8 gray
    without a material) times COLOR_0 times, with a PNG baseColorTexture
    and its TEXCOORD set, the texture sampled bilinearly at each vertex.
    Before baking, textured primitives are subdivided until every edge
    spans at most ``texture_subdiv_texels`` texels (None or 0: never),
    capped at ``max_subdiv_tris`` with a warning. An image that is not a
    PNG or does not decode warns and leaves the factor colour, as in the
    JAX package. Non-triangle primitives raise."""
    base_dir = os.path.dirname(path)
    if path.endswith(".glb"):
        gltf, buffers = _read_glb(_read_file(path))
    else:
        with open(path) as fh:
            gltf = json.load(fh)
        buffers = [_uri_bytes(b.get("uri", ""), base_dir)
                   for b in gltf.get("buffers", [])]

    materials = gltf.get("materials", [])
    images: dict = {}

    def load_image(idx: int):
        if idx in images:
            return images[idx]
        img_def = gltf["images"][idx]
        data = None
        if "bufferView" in img_def:
            view = gltf["bufferViews"][img_def["bufferView"]]
            buf = buffers[view.get("buffer", 0)]
            o = view.get("byteOffset", 0)
            data = buf[o:o + view["byteLength"]]
        elif img_def.get("uri", ""):
            data = _uri_bytes(img_def["uri"], base_dir)
        img = None
        if data is not None and data[:8] == _PNG_SIGNATURE:
            try:
                img = _decode_png(data)
            except Exception as e:  # the factor colour stands, as in JAX
                warnings.warn(f"PNG decode failed for image {idx}: {e}")
        elif data is not None:
            warnings.warn(f"image {idx}: unsupported format (PNG only); "
                          f"using baseColorFactor")
        images[idx] = img
        return img

    def base_color(prim):
        """(factor rgb, texture image or None, uv set)."""
        m = prim.get("material")
        if m is None:
            return (0.8, 0.8, 0.8), None, 0
        pbr = materials[m].get("pbrMetallicRoughness", {})
        tex = pbr.get("baseColorTexture")
        default = [1.0] * 4 if tex is not None else [0.8, 0.8, 0.8, 1.0]
        factor = tuple(pbr.get("baseColorFactor", default)[:3])
        img, uv_set = None, 0
        if tex is not None:
            uv_set = tex.get("texCoord", 0)
            src = gltf["textures"][tex["index"]].get("source")
            if src is not None:
                img = load_image(src)
        return factor, img, uv_set

    def t32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    meshes_out: List[List[Mesh]] = []
    for mesh in gltf.get("meshes", []):
        prims = []
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:
                raise ValueError("only triangle primitives supported")
            attr = prim["attributes"]
            pos = _read_accessor(gltf, buffers, attr["POSITION"])
            if "NORMAL" in attr:
                nrm = _read_accessor(gltf, buffers, attr["NORMAL"])
            else:
                nrm = np.tile([0.0, 1.0, 0.0], (len(pos), 1))
            if "indices" in prim:
                tris = _read_accessor(gltf, buffers, prim["indices"]) \
                    .reshape(-1, 3).astype(np.int32)
            else:
                tris = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
            factor, img, uv_set = base_color(prim)
            if "COLOR_0" in attr:
                vc = _read_accessor(gltf, buffers, attr["COLOR_0"])[:, :3] \
                    .astype(np.float32)
            else:
                vc = np.ones((len(pos), 3), np.float32)
            uv_key = f"TEXCOORD_{uv_set}"
            if img is not None and uv_key in attr:
                uv = _read_accessor(gltf, buffers, attr[uv_key])[:, :2]
                if texture_subdiv_texels:
                    pos, (nrm, vc), uv, tris, _ = subdivide_to_texel_density(
                        pos, [nrm, vc], uv, tris, img.shape[:2],
                        target_texels=float(texture_subdiv_texels),
                        max_tris=max_subdiv_tris)
                    n = np.linalg.norm(nrm, axis=-1, keepdims=True)
                    nrm = nrm / np.maximum(n, 1e-12)
                col = (np.asarray(factor, np.float32)
                       * _sample_bilinear(img, np.asarray(uv, np.float32))
                       .astype(np.float32) * np.asarray(vc, np.float32))
            else:
                col = (np.tile(np.asarray(factor, np.float32), (len(pos), 1))
                       * np.asarray(vc, np.float32))
            prims.append(Mesh(
                positions=t32(pos), normals=t32(nrm), colors=t32(col),
                tris=torch.as_tensor(np.asarray(tris, np.int64),
                                     device=device)))
        meshes_out.append(prims)

    scene = Scene()
    scene_def = gltf.get("scenes", [{}])[gltf.get("scene", 0)]

    def visit(node_idx: int, parent: torch.Tensor):
        node = gltf["nodes"][node_idx]
        world = math3d.affine_compose(
            torch.as_tensor(_node_transform(node)), parent)
        if "mesh" in node:
            for prim in meshes_out[node["mesh"]]:
                scene.instances.append(MeshInstance(
                    mesh=prim, transform=world.to(device),
                    name=node.get("name", f"node{node_idx}")))
        for child in node.get("children", []):
            visit(child, world)

    for root in scene_def.get("nodes", []):
        visit(root, math3d.affine_identity())
    return scene
