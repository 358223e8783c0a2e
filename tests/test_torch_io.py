"""Port parity: file I/O (the port's copies of the JAX package's host
code): ``models/scene_io.py``, ``gltf.py``, ``obj_mtl.py``, the mesh
loaders of ``models/meshes.py``, the HDR readers and writers of
``ops/envmap.py``, ``ops/texture.load_texture``, ``utils/exr.py`` and the
rest of ``utils/image.py``.

Every scene of ``examples/`` (five JSON files, two glb files) and an OBJ
+ MTL asset written here load to the JAX package's scene field by field,
bit for bit (integer tables and float arrays alike: both build in numpy;
the JAX side's native BVH builder is off), with an equal camera. The
OBJ, PLY, HDR (flat and run-length), EXR and PNG files are written by the
tests themselves and read back by both packages: equal arrays, equal
bytes. Nothing is downloaded.
"""

import dataclasses
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import gltf as jgltf
from pathtracing_tpu.models import meshes as jmeshes
from pathtracing_tpu.models import obj_mtl as jobj
from pathtracing_tpu.models import scene_io as jio
from pathtracing_tpu.ops import bvh_native
from pathtracing_tpu.ops import envmap as jenv
from pathtracing_tpu.ops import texture as jtex
from pathtracing_tpu.utils import exr as jexr
from pathtracing_tpu.utils import image as jimage
from pathtracing_tpu_torch.models import gltf as tgltf
from pathtracing_tpu_torch.models import meshes as tmeshes
from pathtracing_tpu_torch.models import obj_mtl as tobj
from pathtracing_tpu_torch.models import scene_io as tio
from pathtracing_tpu_torch.models.scene import SceneBuilder
from pathtracing_tpu_torch.ops import envmap as tenv
from pathtracing_tpu_torch.ops import texture as ttex
from pathtracing_tpu_torch.utils import exr as texr
from pathtracing_tpu_torch.utils import image as timage

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
JSON_SCENES = ("cornell", "motion", "outdoor", "showcase", "studio")
GLB_SCENES = ("gltf_demo", "gltf_torture")


@pytest.fixture(autouse=True)
def _numpy_bvh(monkeypatch):
    """Both packages build the BVH order in numpy."""
    monkeypatch.setattr(bvh_native, "build", lambda *a, **k: None)


# Scene fields that hold tables, compared field by field; the JAX-only
# TPU layout the port drops.
TABLES = ("clusters", "lights", "instances", "pages", "env", "delta", "bvh",
          "textures", "vol")
DROPPED = {"cand_box"}


def _fields_of(x):
    if hasattr(x, "_asdict"):
        return x._asdict()
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def _equal(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _same_scene(pair, label, cams=None):
    """Every field of the port's scene equals the JAX scene's, bit for bit,
    and the None pattern of the optional columns and tables too."""
    sj, st = pair
    jf = sj._asdict()
    for f, b in st._asdict().items():
        # A port-only field (``inst_tree``) reads None on the JAX side,
        # so the port's must be None too.
        a = jf.get(f)
        assert (a is None) == (b is None), (label, f)
        if a is None:
            continue
        if f not in TABLES:
            _equal(a, b, (label, f))
            continue
        ta, tb = _fields_of(a), _fields_of(b)
        assert set(ta) - set(tb) <= DROPPED, (label, f)
        for g, y in tb.items():
            if g in ta:
                assert (ta[g] is None) == (y is None), (label, f, g)
                if y is not None:
                    _equal(ta[g], y, (label, f, g))
    for f in set(jf) - set(st._fields):
        assert jf[f] is None, (label, f)
    if cams is not None:
        assert dataclasses.asdict(cams[0]) == dataclasses.asdict(cams[1])


@pytest.mark.parametrize("name", JSON_SCENES)
def test_example_json_scene_loads_to_the_jax_scene(name):
    path = os.path.join(EXAMPLES, name + ".json")
    sj, cj = jio.load_scene(path)
    st, ct = tio.load_scene(path, device="cpu")
    assert st.tri_v0.device.type == "cpu"
    _same_scene((sj, st), name, (cj, ct))
    assert tio.preferred_background(path) == jio.preferred_background(path)


@pytest.mark.parametrize("name", GLB_SCENES)
def test_example_glb_loads_to_the_jax_scene(name):
    path = os.path.join(EXAMPLES, name + ".glb")
    sj, cj = jgltf.load_gltf(path)
    st, ct = tgltf.load_gltf(path, device="cpu")
    _same_scene((sj, st), name, (cj, ct))


def test_loaders_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: tio.load_scene(os.path.join(EXAMPLES,
                                                   "cornell.json")),
               lambda: tgltf.load_gltf(os.path.join(EXAMPLES,
                                                    "gltf_demo.glb")),
               lambda: tenv.load_environment({"uniform": [1, 1, 1]})):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


MTL = """
newmtl matte
Kd 0.60 0.20 0.20
Ns 10
newmtl floor
Kd 0.50 0.50 0.55
Ks 0.04 0.04 0.04
Ns 250
map_Kd grid.png
bump -bm 0.5 bumps.png
newmtl mirror
Ks 0.95 0.95 0.95
illum 5
Ns 1000
newmtl glass
Kd 0.9 0.9 0.9
Ni 1.52
d 0.1
illum 7
newmtl lamp
Ke 12.0 11.0 10.0
"""

OBJ = """
mtllib scene.mtl missing.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
v 1 0 1
v 1 1 1
v 0 1 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
usemtl matte
f 1 2 3 4
usemtl floor
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl mirror
f 5 6 7
usemtl glass
f 5 7 8
usemtl lamp
f -8 -7 -6
usemtl unknown
f 1 3 8
"""


def test_obj_mtl_asset_loads_to_the_jax_scene(tmp_path):
    from PIL import Image

    (tmp_path / "scene.mtl").write_text(MTL)
    (tmp_path / "scene.obj").write_text(OBJ)
    with open(os.path.join(EXAMPLES, "grid.png"), "rb") as f:
        (tmp_path / "grid.png").write_bytes(f.read())
    Image.fromarray(np.full((2, 2, 3), (128, 128, 255), np.uint8)).save(
        tmp_path / "bumps.png")
    path = str(tmp_path / "scene.obj")
    sj, cj = jobj.load_obj_scene(path)
    st, ct = tobj.load_obj_scene(path, device="cpu")
    assert st.textures is not None and st.attr_uv is not None
    _same_scene((sj, st), "obj_mtl", (cj, ct))


def test_obj_round_trip_and_full_attributes(tmp_path):
    rs = np.random.RandomState(0)
    verts = rs.randn(12, 3)
    faces = rs.randint(0, 12, (9, 3))
    path = str(tmp_path / "m.obj")
    tmeshes.save_obj(path, verts, faces)
    jpath = str(tmp_path / "j.obj")
    jmeshes.save_obj(jpath, verts, faces)
    assert open(path).read() == open(jpath).read()
    v, f = tmeshes.load_obj(path)
    np.testing.assert_array_equal(v, verts)
    np.testing.assert_array_equal(f, faces)
    # Polygons, negative indices, uvs and normals on every corner.
    (tmp_path / "full.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
        "vt 0 1\nvn 0 0 1\nf 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "f -4/-4/-1 -2/-2/-1 -1/-1/-1\n")
    for a, b in zip(jmeshes.load_obj_full(str(tmp_path / "full.obj")),
                    tmeshes.load_obj_full(str(tmp_path / "full.obj"))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no triangles"):
        (tmp_path / "empty.obj").write_text("v 0 0 0\n")
        tmeshes.load_obj(str(tmp_path / "empty.obj"))


def test_fit_to_box_and_transform_match_jax():
    v = np.random.RandomState(1).randn(30, 3)
    np.testing.assert_array_equal(
        tmeshes.fit_to_box(v, (0.0, -0.5, 1.0), 2.0),
        jmeshes.fit_to_box(v, (0.0, -0.5, 1.0), 2.0))
    np.testing.assert_array_equal(
        tmeshes.transform(v, 1.5, 30.0, (1.0, 2.0, 3.0)),
        jmeshes.transform(v, 1.5, 30.0, (1.0, 2.0, 3.0)))


PLY_VERTS = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, -1.0], [1.0, 0.0, -1.0],
                      [1.0, 0.0, 1.0], [-1.0, 0.0, 1.0]])
PLY_FACES = [(0, 1, 2), (0, 2, 3), (0, 3, 4), (0, 4, 1), (1, 4, 3, 2)]


def _write_ply_ascii(path):
    lines = ["ply", "format ascii 1.0", "comment written by the test",
             "element vertex 5", "property float x", "property float y",
             "property float z", "property float nx", "property float ny",
             "property float nz", "property float u", "property float v",
             "element face 5", "property list uchar int vertex_indices",
             "end_header"]
    for i, v in enumerate(PLY_VERTS):
        lines.append(" ".join(f"{x:.6f}" for x in
                              [*v, 0.0, 1.0, 0.0, i / 10.0, i / 5.0]))
    lines += [f"{len(f)} " + " ".join(map(str, f)) for f in PLY_FACES]
    path.write_text("\n".join(lines) + "\n")


def _write_ply_binary(path):
    header = (b"ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
              b"property float x\nproperty float y\nproperty float z\n"
              b"element face 5\nproperty list uchar int vertex_indices\n"
              b"end_header\n")
    body = b"".join(struct.pack("<fff", *v) for v in PLY_VERTS)
    body += b"".join(struct.pack("<B", len(f)) + struct.pack(
        f"<{len(f)}i", *f) for f in PLY_FACES)
    path.write_bytes(header + body)


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_ply_loads_as_jax_does(tmp_path, fmt):
    path = tmp_path / f"m_{fmt}.ply"
    (_write_ply_ascii if fmt == "ascii" else _write_ply_binary)(path)
    got = tmeshes.load_ply(str(path))
    want = jmeshes.load_ply(str(path))
    assert got[1].shape == (6, 3)
    for a, b in zip(want, got):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    (tmp_path / "bad.ply").write_bytes(b"nope\nend_header\n")
    with pytest.raises(ValueError, match="not a PLY"):
        tmeshes.load_ply(str(tmp_path / "bad.ply"))


def _hdr_image():
    rs = np.random.RandomState(2)
    img = (rs.rand(5, 16, 3) * 8).astype(np.float32) ** 2
    img[0] = 0.5                 # a constant row (runs)
    img[1, :, 1] = 0.0
    img[2, 3] = 0.0              # a black texel (exponent 0)
    return img


def test_hdr_flat_round_trip(tmp_path):
    img = _hdr_image()
    path = str(tmp_path / "a.hdr")
    tenv.write_hdr(path, img)
    jenv.write_hdr(str(tmp_path / "b.hdr"), img)
    assert open(path, "rb").read() == open(tmp_path / "b.hdr", "rb").read()
    back = tenv.load_hdr(path)
    np.testing.assert_array_equal(back, jenv.load_hdr(path))
    # RGBE keeps 8 mantissa bits: within 1/256 of each texel's peak.
    assert np.all(np.abs(back - img)
                  <= img.max(-1, keepdims=True) / 128 + 1e-30)
    np.testing.assert_array_equal(tenv._rgbe_encode(img),
                                  jenv._rgbe_encode(img))


def test_hdr_run_length_scanlines(tmp_path):
    img = _hdr_image()
    h, w, _ = img.shape
    rgbe = tenv._rgbe_encode(img)
    path = str(tmp_path / "rle.hdr")
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for row in range(h):
            f.write(bytes([2, 2, w >> 8, w & 0xFF]))
            for c in range(4):
                col = rgbe[row, :, c]
                if np.all(col == col[0]):
                    f.write(bytes([128 + w, int(col[0])]))
                else:
                    f.write(bytes([w]) + col.tobytes())
    np.testing.assert_array_equal(tenv.load_hdr(path), jenv.load_hdr(path))
    np.testing.assert_array_equal(tenv.load_hdr(path),
                                  tenv._rgbe_decode(rgbe))


@pytest.mark.parametrize("spec", [
    {"image": "probe.hdr", "scale": 2.0, "rotate_degrees": 90},
    {"sky": {"width": 32, "height": 16}},
    {"uniform": [0.2, 0.4, 0.6], "resolution": [8, 16], "scale": 0.5},
])
def test_load_environment_matches_jax(tmp_path, spec):
    jenv.write_hdr(str(tmp_path / "probe.hdr"), _hdr_image())
    env_j = jenv.load_environment(spec, str(tmp_path))
    env_t = tenv.load_environment(spec, str(tmp_path), device="cpu")
    for name in env_t._fields:
        np.testing.assert_array_equal(getattr(env_t, name).numpy(),
                                      np.asarray(getattr(env_j, name)))
    assert tenv.load_environment(None, device="cpu") is None
    with pytest.raises(ValueError, match="unknown environment"):
        tenv.environment_texels({"cube": 1})


@pytest.mark.parametrize("srgb", [True, False])
def test_load_texture_matches_jax(tmp_path, srgb):
    png = os.path.join(EXAMPLES, "grid.png")
    got = ttex.load_texture(png, srgb=srgb)
    np.testing.assert_array_equal(got, jtex.load_texture(png, srgb=srgb))
    assert got.dtype == np.float32 and got.ndim == 3
    npy = str(tmp_path / "t.npy")
    np.save(npy, got[:4, :4] * 3.0)
    np.testing.assert_array_equal(ttex.load_texture(npy),
                                  jtex.load_texture(npy))
    # SceneBuilder.add_texture takes the path (no longer refused).
    b = SceneBuilder()
    tid = b.add_texture(png, srgb=srgb)
    np.testing.assert_array_equal(b._tex[tid], got)


def test_exr_round_trip_and_bytes(tmp_path):
    img = (np.random.RandomState(4).randn(7, 9, 3) * 100).astype(
        np.float32)
    data = texr.encode_exr(img)
    assert data == jexr.encode_exr(img)
    path = str(tmp_path / "a.exr")
    texr.write_exr(path, img)
    np.testing.assert_array_equal(texr.read_exr(path), img)
    np.testing.assert_array_equal(jexr.read_exr(path), img)


def test_png_round_trip_and_write_image(tmp_path):
    rs = np.random.RandomState(5)
    rgb8 = rs.randint(0, 256, (6, 11, 3)).astype(np.uint8)
    data = timage.encode_png(rgb8)
    np.testing.assert_array_equal(timage.decode_png(data), rgb8)
    np.testing.assert_array_equal(jimage.decode_png(data), rgb8)
    img = (rs.rand(6, 11, 3) * 2).astype(np.float32)
    for ext in ("png", "ppm", "hdr", "exr"):
        tp, jp = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
        timage.write_image(tp, torch.as_tensor(img), exposure=1.5)
        jimage.write_image(jp, jnp.asarray(img), exposure=1.5)
        if ext in ("hdr", "exr"):
            assert open(tp, "rb").read() == open(jp, "rb").read(), ext
        else:
            # The sRGB transfer's pow may round an 8-bit code apart
            # (tests/test_torch_port.py's tonemap tolerance).
            a = open(tp, "rb").read()
            b = open(jp, "rb").read()
            if ext == "png":
                a, b = timage.decode_png(a), jimage.decode_png(b)
            else:
                a, b = (np.frombuffer(x[-6 * 11 * 3:], np.uint8)
                        for x in (a, b))
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, ext
    np.testing.assert_allclose(texr.read_exr(str(tmp_path / "t.exr")),
                               img * 1.5, rtol=1e-6)
    assert timage.rmse(img, img * 0.5) == jimage.rmse(img, img * 0.5)
