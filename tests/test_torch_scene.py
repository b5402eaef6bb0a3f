"""The glTF scene path of vrenderer_tpu_torch against vrenderer_tpu's on the
CPU: ``load_gltf`` (.gltf with data-URI and external buffers, .glb,
textures baked after ``subdivide_to_texel_density``, COLOR_0, the node
hierarchy), the PNG decoder, the bilinear bake, node transforms and
``Scene.ensure_light``. Both packages read the same files. Load-time work
is numpy in both, so every array is held exactly, except normals (1e-6)
and transforms, which JAX composes with an XLA product (1e-6)."""

import base64
import dataclasses
import json
import struct
import warnings
import zlib

import numpy as np
import pytest

from chip_smoke import png_bytes, scene_texture, write_scene_glb
from vrenderer_tpu.models import mesh as jmesh
from vrenderer_tpu.models import scene as jscene
from vrenderer_tpu_torch.models import mesh as pmesh
from vrenderer_tpu_torch.models import scene as pscene


def _b64(data: bytes, mime="application/octet-stream") -> str:
    return f"data:{mime};base64," + base64.b64encode(data).decode()


def _gltf(tmp_path, name, prims, buf, nodes=None, extra=None, uri=None):
    """A .gltf of one mesh with ``prims`` over accessors of ``buf``'s
    (offset, count, type, component) views; the buffer as a data URI or,
    with ``uri``, an external file."""
    views, accs = [], []
    for off, length, count, kind, ctype in buf["views"]:
        views.append({"buffer": 0, "byteOffset": off, "byteLength": length})
        accs.append({"bufferView": len(views) - 1, "componentType": ctype,
                     "count": count, "type": kind})
    if uri is not None:
        (tmp_path / uri).write_bytes(buf["data"])
    g = {"asset": {"version": "2.0"}, "scene": 0,
         "scenes": [{"nodes": [0]}],
         "nodes": nodes or [{"mesh": 0}],
         "meshes": [{"primitives": prims}],
         "accessors": accs, "bufferViews": views,
         "buffers": [{"uri": uri or _b64(buf["data"]),
                      "byteLength": len(buf["data"])}]}
    g.update(extra or {})
    p = tmp_path / name
    p.write_text(json.dumps(g))
    return str(p)


def _buffer(*arrays):
    """Pack arrays 4-byte aligned: {"data", "views": (offset, length,
    count, type, component)}."""
    data, views = b"", []
    kinds = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4"}
    comps = {np.dtype(np.float32): 5126, np.dtype(np.uint16): 5123,
             np.dtype(np.uint32): 5125, np.dtype(np.uint8): 5121}
    for a in arrays:
        data += b"\0" * (-len(data) % 4)
        n = a.shape[1] if a.ndim == 2 else 1
        views.append((len(data), a.nbytes, a.shape[0], kinds[n],
                      comps[a.dtype]))
        data += a.tobytes()
    return {"data": data, "views": views}


QUAD_POS = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                      np.float32)
QUAD_UV = np.asarray([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
QUAD_IDX = np.asarray([0, 1, 2, 1, 3, 2], np.uint16)


def _case_data_uri_triangle(tmp_path):
    """tests/test_scene.py's minimal .gltf: data URI, node TRS, factor."""
    buf = _buffer(QUAD_POS[:3], np.asarray([0, 1, 2], np.uint16))
    return _gltf(
        tmp_path, "tri.gltf",
        [{"attributes": {"POSITION": 0}, "indices": 1, "material": 0}], buf,
        nodes=[{"mesh": 0, "translation": [1.0, 2.0, 3.0],
                "scale": [2.0, 2.0, 2.0]}],
        extra={"materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.1, 0.2, 0.9, 1.0]}}]})


def _case_glb_scene(tmp_path):
    """The editor scene of chip_smoke.py at a 16-texel texture: GLB, PNG in
    the binary chunk with every filter, subdivision, COLOR_0, a node
    hierarchy with rotation, non-uniform scale and a matrix node."""
    p = tmp_path / "scene.glb"
    write_scene_glb(str(p), tex_size=16, quad_size=20.0,
                    center=(0.0, 9.0, 0.0))
    return str(p)


def _case_external_textured(tmp_path):
    """External .bin buffer and .png image, TEXCOORD_1 selected by
    texCoord, normals renormalised after subdivision, no indices."""
    (tmp_path / "tex.png").write_bytes(png_bytes(scene_texture(8, 3)))
    pos = QUAD_POS[[0, 1, 2, 1, 3, 2]]
    nrm = np.tile(np.asarray([[0.3, 0.2, -1.0]], np.float32), (6, 1))
    uv0 = np.zeros((6, 2), np.float32)
    uv1 = QUAD_UV[[0, 1, 2, 1, 3, 2]] * 1.5 - 0.25
    buf = _buffer(pos, nrm, uv0, uv1)
    return _gltf(
        tmp_path, "ext.gltf",
        [{"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2,
                         "TEXCOORD_1": 3}, "material": 0}], buf,
        uri="ext.bin",
        extra={"materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0, "texCoord": 1}}}],
            "textures": [{"source": 0}], "images": [{"uri": "tex.png"}]})


def _case_image_layouts(tmp_path):
    """Gray, gray+alpha and RGBA PNGs as data URIs, one primitive each."""
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (7, 9) + c, dtype=np.uint8)
            for c in ((), (2,), (4,))]
    buf = _buffer(QUAD_POS, QUAD_UV, QUAD_IDX)
    prim = {"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 2}
    return _gltf(
        tmp_path, "layouts.gltf",
        [dict(prim, material=k) for k in range(3)], buf,
        extra={"materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": k}}} for k in range(3)],
            "textures": [{"source": k} for k in range(3)],
            "images": [{"uri": _b64(png_bytes(im), "image/png")}
                       for im in imgs]})


def _case_vertex_colors(tmp_path):
    """COLOR_0 as normalized uint8 VEC4 under the default material."""
    vc = np.asarray([[255, 0, 0, 255], [0, 128, 0, 255], [0, 0, 255, 9]],
                    np.uint8)
    buf = _buffer(QUAD_POS[:3], vc, np.asarray([0, 1, 2], np.uint16))
    path = _gltf(tmp_path, "vc.gltf",
                 [{"attributes": {"POSITION": 0, "COLOR_0": 1},
                   "indices": 2}], buf)
    g = json.loads(open(path).read())
    g["accessors"][1]["normalized"] = True
    (tmp_path / "vc.gltf").write_text(json.dumps(g))
    return path


CASES = {
    "data_uri_triangle": _case_data_uri_triangle,
    "glb_scene": _case_glb_scene,
    "external_textured": _case_external_textured,
    "image_layouts": _case_image_layouts,
    "vertex_colors": _case_vertex_colors,
}


def assert_scenes_equal(port, jax_scene):
    assert len(port.instances) == len(jax_scene.instances) > 0
    for a, b in zip(port.instances, jax_scene.instances):
        assert a.name == b.name
        for f in ("positions", "colors", "tris"):
            np.testing.assert_array_equal(
                getattr(a.mesh, f).numpy(), np.asarray(getattr(b.mesh, f)),
                err_msg=f)
        np.testing.assert_allclose(a.mesh.normals.numpy(),
                                   np.asarray(b.mesh.normals), atol=1e-6)
        np.testing.assert_allclose(a.transform.numpy(),
                                   np.asarray(b.transform), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_gltf_matches_jax(tmp_path, case):
    path = CASES[case](tmp_path)
    assert_scenes_equal(pscene.load_gltf(path, device="cpu"),
                        jscene.load_gltf(path))


def test_load_gltf_subdivides_the_editor_texture(tmp_path):
    """The editor scene's quad reaches 1 texel/edge: 16-texel texture over
    0.7 of its span -> 512 triangles, the box and its cap 12 each; and
    subdivision off keeps the quad's two triangles."""
    path = _case_glb_scene(tmp_path)
    sc = pscene.load_gltf(path, device="cpu")
    assert [i.name for i in sc.instances] == ["quad", "pillar", "cap"]
    assert [i.mesh.num_tris for i in sc.instances] == [512, 12, 12]
    flat = pscene.load_gltf(path, texture_subdiv_texels=0, device="cpu")
    assert flat.instances[0].mesh.num_tris == 2
    assert_scenes_equal(flat, jscene.load_gltf(path,
                                               texture_subdiv_texels=0))


@pytest.mark.parametrize("bad", ["garbled_png", "jpeg"])
def test_undecodable_image_warns_and_keeps_the_factor(tmp_path, bad):
    """JAX's data behaviour: a PNG that does not decode, or another
    format, warns and leaves the base colour factor."""
    data = (png_bytes(scene_texture(4, 1))[:40] if bad == "garbled_png"
            else b"\xff\xd8\xff\xe0" + bytes(32))
    buf = _buffer(QUAD_POS, QUAD_UV, QUAD_IDX)
    path = _gltf(
        tmp_path, "bad.gltf",
        [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 2,
          "material": 0}], buf,
        extra={"materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "baseColorFactor": [0.5, 0.25, 1.0, 1.0]}}],
            "textures": [{"source": 0}],
            "images": [{"uri": _b64(data, "image/png")}]})
    with pytest.warns(UserWarning, match="image 0|PNG decode"):
        sc = pscene.load_gltf(path, device="cpu")
    with pytest.warns(UserWarning):
        ref = jscene.load_gltf(path)
    assert_scenes_equal(sc, ref)
    np.testing.assert_array_equal(sc.instances[0].mesh.colors.numpy(),
                                  np.tile([0.5, 0.25, 1.0], (4, 1)))


def _filter_bytes(png: bytes, row: int, kind: int) -> bytes:
    """``png`` with row ``row``'s filter byte set to ``kind`` (the row's
    bytes unchanged, so it decodes differently)."""
    pos, out = 8, png[:8]
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        tag, body = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, _, _, color = struct.unpack(">IIBB", body[:10])
            stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[color] + 1
        if tag == b"IDAT":
            raw = bytearray(zlib.decompress(body))
            raw[row * stride] = kind
            body = zlib.compress(bytes(raw))
        out += (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))
        pos += 12 + n
    return out


@pytest.mark.parametrize("channels", [(), (2,), (3,), (4,)])
def test_decode_png_matches_jax(channels):
    """Every filter (rows cycle None, Sub, Up, Average, Paeth; a filter
    byte above 4 reads as Paeth in both) and channel layout; a bad CRC is
    not checked, as in the JAX decoder."""
    rng = np.random.default_rng(len(channels))
    img = rng.integers(0, 256, (11, 13) + channels, dtype=np.uint8)
    png = png_bytes(img)
    out = pscene._decode_png(png)
    assert out.shape == (11, 13, 3) and out.dtype == np.float32
    np.testing.assert_array_equal(out, jscene._decode_png(png))
    full = img if channels else img[..., None]
    np.testing.assert_array_equal(
        out[..., 0], full[..., 0].astype(np.float32) / 255.0)
    odd = _filter_bytes(png, 3, 7)
    np.testing.assert_array_equal(pscene._decode_png(odd),
                                  jscene._decode_png(odd))
    bad_crc = png[:-5] + bytes([png[-5] ^ 1]) + png[-4:]
    np.testing.assert_array_equal(pscene._decode_png(bad_crc), out)


def test_sample_bilinear_and_node_transforms_match_jax():
    rng = np.random.default_rng(2)
    img = rng.random((5, 7, 3)).astype(np.float32)
    uv = np.concatenate([rng.uniform(-1.5, 2.5, (200, 2)),
                         [[0.0, 0.0], [1.0, 1.0], [2.0, -1.0], [0.5, 1.0]]])
    uv = uv.astype(np.float32)
    np.testing.assert_array_equal(pscene._sample_bilinear(img, uv),
                                  jscene._sample_bilinear(img, uv))
    nodes = [{}, {"translation": [1, 2, 3]},
             {"rotation": [0.2, -0.4, 0.1, 0.89], "scale": [2, 0.5, 3]},
             {"matrix": list(rng.normal(size=16))}]
    for node in nodes:
        np.testing.assert_array_equal(pscene._node_transform(node),
                                      jscene._node_transform(node))


@pytest.mark.parametrize("case", ["triangle_17", "capped", "adaptive_1024"])
def test_subdivide_to_texel_density_matches_jax(case):
    """tests/test_mesh_texture.py's cases, array for array, with the same
    warning when capped."""
    if case == "adaptive_1024":
        pos = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                          [3, 0, 0], [4, 0, 0], [4, 1, 0], [3, 1, 0]],
                         np.float32)
        uv = np.asarray([[0, 0], [64, 0], [64, 64], [0, 64],
                         [0, 0], [16, 0], [16, 16], [0, 16]],
                        np.float32) / 1023
        tris = np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]])
        kw = dict(tex_shape=(1024, 1024), target_texels=1.0)
    else:
        pos = QUAD_POS[:3]
        uv = QUAD_UV[:3]
        tris = np.asarray([[0, 1, 2]])
        kw = (dict(tex_shape=(17, 17), target_texels=1.0)
              if case == "triangle_17" else
              dict(tex_shape=(1024, 1024), target_texels=0.1,
                   max_tris=1000))
    nrm = np.tile([[0.0, 0.0, 1.0]], (len(pos), 1))
    col = np.random.default_rng(0).random((len(pos), 3))
    outs = []
    for fn in (pmesh.subdivide_to_texel_density,
               jmesh.subdivide_to_texel_density):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            outs.append((fn(pos, [nrm, col], uv, tris, **kw),
                         [str(r.message) for r in rec]))
    (p, (n, c), u, t, ach), msgs = outs[0]
    (jp, (jn, jc), ju, jt, jach), jmsgs = outs[1]
    for a, b in ((p, jp), (n, jn), (c, jc), (u, ju), (t, jt)):
        np.testing.assert_array_equal(a, b)
    assert ach == jach
    assert len(msgs) == len(jmsgs) == (case == "capped")
    if msgs:
        assert f"{ach:.1f}" in msgs[0] and "max_tris=1000" in msgs[0]
        assert msgs[0] == jmsgs[0].split(" Reference parity")[0]


def test_ensure_light():
    from vrenderer_tpu.config import LightParams as JLight

    sc = pscene.Scene()
    light = sc.ensure_light()
    assert sc.light is light
    assert dataclasses.asdict(light) == dataclasses.asdict(JLight())
    own = dataclasses.replace(light, irradiance=3.0)
    sc.light = own
    assert sc.ensure_light() is own
    assert pscene.Scene.default().ensure_light().irradiance == 1.0


def test_mesh_top_field_slivers_are_ill_conditioned(tmp_path):
    """With the editor scene's root turned 20 degrees about y, the pillar's
    vertical faces become slivers in the top-down mesh-top raster, whose
    depth planes are ill-conditioned: the packages' world-space top
    triangles differ by a few ulp (an einsum's summation order), and
    JAX's own mesh_top_field moves by about a metre between the two. On
    the same triangles the port's field equals JAX's exactly (ROADMAP C;
    the editor tests load the scene unrotated)."""
    import jax.numpy as jnp
    import torch

    from torch_parity import CFG, JCFG
    from vrenderer_tpu.ops import shadow as jshadow
    from vrenderer_tpu.renderer import Renderer as JRenderer
    from vrenderer_tpu_torch.ops import shadow as pshadow
    from vrenderer_tpu_torch.renderer import Renderer

    path = str(tmp_path / "rotated.glb")
    write_scene_glb(path, tex_size=16, quad_size=20.0,
                    center=(0.0, 14.0, 0.0), root_yaw=20.0)
    hm = np.zeros((64, 64), np.float32)
    jr = JRenderer(JCFG, jnp.asarray(hm), None, raster_backend="xla",
                   scene=jscene.load_gltf(path))
    r = Renderer(CFG, torch.as_tensor(hm), None, raster_backend="xla",
                 scene=pscene.load_gltf(path, device="cpu"), device="cpu")
    jtop = np.asarray(jr._scene_top_world(jr.scene_transforms))
    ptop = r._scene_top_world(r.scene_transforms).numpy()[:, :jtop.shape[1]]
    ulp = np.abs(jtop.view(np.int32).astype(np.int64)
                 - ptop.view(np.int32).astype(np.int64))
    assert 0 < ulp.max() <= 16

    def field(fn, top, valid):
        f = np.asarray(fn(top, valid, 64.0, 64))
        return np.where(f > -1e8, f, 0.0)

    j_on_j = field(jshadow.mesh_top_field, jnp.asarray(jtop),
                   jnp.ones((1,), bool))
    j_on_p = field(jshadow.mesh_top_field, jnp.asarray(ptop),
                   jnp.ones((1,), bool))
    p_on_j = field(pshadow.mesh_top_field, torch.as_tensor(jtop.copy()),
                   torch.ones((1,), dtype=torch.bool))
    np.testing.assert_array_equal(p_on_j, j_on_j)
    assert np.abs(j_on_p - j_on_j).max() > 0.1
