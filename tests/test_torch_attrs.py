"""Port parity: surface attributes (ROADMAP queue A item 12). The same
builder calls and the same numpy rays, from fixed seeds, go through the
JAX package and the port on the CPU.

* Every ``Scene`` field equals the JAX one bit for bit for the textured,
  smooth-shaded cornell_mesh(3) paged by 8 clusters a page
  (``scenes.textured_cornell_mesh_builder``: the slot map through
  ``build_pages``, the BVH retarget and ``attr_pack``), and for an
  instanced scene whose base geometry carries uvs (prototype slots padded
  with -1). The three registry scenes are held in
  ``tests/test_torch_scenes.py``.
* ``smooth_vertex_normals`` and ``remap_slot_to_tri`` equal the JAX ones.
* ``Hit.prim`` equals the JAX one on the cluster routes (through
  ``slot_to_tri``) and on the "bvh" route; ``surface_attributes`` on real
  hits, through the slot branch (``attr_pack``) and the prim branch, with
  and without a ray cone, within the float noise the test states.
* The textured light columns (small and packed tables) equal the JAX
  ones bit for bit, and so do the atlas ids and emissions that
  ``sample_solid_angle(with_uv=True)`` returns; its point, normal,
  emission and pdf equal the port's call without uvs. Its uvs, points,
  normals and pdfs agree with the JAX ones within the float noise of the
  triangle and the sphere-cone samplers: torch's CPU sqrt is one ulp off
  the correctly rounded value for some inputs (sqrt(0.32235706) gives
  0.56776494, numpy and XLA 0.567765), which moves the barycentric
  weights; measured: uvs within 6e-8, points 4.6e-6, normals 1.5e-5 (the
  sphere lamp's cone), pdfs 1e-5 relative.
* ``render_once`` of textured_demo, bump_demo, screenlight_demo and mips
  textured_demo (depth 6, so the ray cone crosses the live-first
  compaction at depth 3) agrees with the JAX CPU render
  (``traversal="cluster_jax"``) at 24x24, 3 spp. Measured: largest
  per-pixel difference 1.1e-5 (textured_demo), 3.2e-5 (bump_demo), 7e-7
  (mips textured_demo, depth 6); screenlight_demo has one pixel of 576
  over 1e-3 (1.45e-3 on an image of mean 1.45), the rest below. The test
  allows 1% of pixels over 1e-3 and means within 1%, as
  ``tests/test_torch_render.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.models import meshes as jmeshes
from pathtracing_tpu.models import progressive as jprog
from pathtracing_tpu.models import scene as jscene_mod
from pathtracing_tpu.models import scenes as jscenes
from pathtracing_tpu.ops import bvh_native
from pathtracing_tpu.ops import clusters as jclusters
from pathtracing_tpu.ops import lights as jlights
from pathtracing_tpu.ops import texture as jtex
from pathtracing_tpu.ops.camera import build_camera as jcamera
from pathtracing_tpu.ops.camera import generate_ray as jgenerate_ray
from pathtracing_tpu.utils.config import RenderConfig as JConfig
from pathtracing_tpu_torch.models import meshes as tmeshes
from pathtracing_tpu_torch.models import progressive as tprog
from pathtracing_tpu_torch.models import scene as tscene_mod
from pathtracing_tpu_torch.models import scenes as tscenes
from pathtracing_tpu_torch.ops import clusters as tclusters
from pathtracing_tpu_torch.ops import lights as tlights
from pathtracing_tpu_torch.ops import texture as ttex
from pathtracing_tpu_torch.ops.camera import build_camera as tcamera
from pathtracing_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                        b.dtype, a.shape,
                                                        b.shape)
    assert a.tobytes() == b.tobytes(), what


def _fields(x):
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def _scene_equal(sj, st):
    """Every field of the port's Scene equals the JAX one (tables field by
    field; the JAX-only ``cand_box`` is dropped by design)."""
    jf = sj._asdict()
    for f, b in st._asdict().items():
        # A port-only field (``inst_tree``) reads None on the JAX side,
        # so the port's must be None too.
        a = jf.get(f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        if not hasattr(b, "_fields"):
            _equal(a, b, f)
            continue
        ta = _fields(a)
        for g, y in b._asdict().items():
            if g in ta and g != "cand_box":
                assert (ta[g] is None) == (y is None), (f, g)
                if y is not None:
                    _equal(ta[g], y, (f, g))
    for f in set(jf) - set(st._fields):
        assert jf[f] is None, f


def _instanced_builder(builder_cls):
    b = builder_cls()
    tex = b.add_texture(tscenes.grid_texture(16, 4))
    ground = b.lambertian((0.8, 0.8, 0.8), texture=tex)
    b.add_quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), ground,
               uv=True)
    light = b.emissive((20.0, 20.0, 20.0))
    b.add_quad((-1.0, 5.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), light)
    verts, faces = tscenes.icosphere(1, 0.4)
    mats = [b.lambertian((0.7, 0.3, 0.25)), b.metal((0.8, 0.8, 0.9), 0.1)]
    ts, overrides = tscenes.instanced_field(3, mats)
    b.add_instances(verts, faces, mats[0], ts, materials=overrides)
    return b


@pytest.fixture(scope="module")
def built():
    """{name: (JAX scene, port scene, camera config)}."""
    from pathtracing_tpu.models.scene import SceneBuilder as JBuilder

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        cam = tscenes.CORNELL_CAMERA
        out["paged"] = tuple(
            tscenes.textured_cornell_mesh_builder(3, builder=b).build(
                *dev, page_clusters=8)
            for b, dev in ((JBuilder, ()), (tscene_mod.SceneBuilder,
                                            ("cpu",)))) + (cam,)
        out["instanced"] = (_instanced_builder(JBuilder).build(),
                            _instanced_builder(
                                tscene_mod.SceneBuilder).build("cpu"),
                            tscenes.CameraConfig(position=(0.0, 4.0, 9.0),
                                                 look_at=(0.0, 0.4, 0.0),
                                                 vfov_degrees=42.0))
        for name in ("textured_demo", "bump_demo", "screenlight_demo"):
            sj, cc = jscenes.SCENES[name]()
            out[name] = (sj, tscenes.get_scene(name, device="cpu")[0], cc)
    return out


@pytest.mark.parametrize("name", ["paged", "instanced"])
def test_attribute_scene_fields_equal(built, name):
    sj, st, _ = built[name]
    _scene_equal(sj, st)
    assert st.attr_pack is not None and st.slot_to_tri is not None
    if name == "paged":
        assert st.pages is not None and st.pages.node_box.shape[0] >= 2
        assert st.attr_shn is not None
    else:
        n_base = int((st.instances.inst_id == 0).sum())
        assert st.instances is not None
        # Prototype slots carry no rows: -1 past the base clusters.
        assert bool((st.slot_to_tri[n_base * 128:] == -1).all())


def test_smooth_vertex_normals_match_jax():
    verts, faces = tscenes.icosphere(2, 1.3)
    rs = np.random.RandomState(3)
    verts = verts + rs.normal(0.0, 0.02, verts.shape)
    _equal(jmeshes.smooth_vertex_normals(verts, faces),
           tmeshes.smooth_vertex_normals(verts, faces), "normals")


def test_remap_slot_to_tri_matches_jax():
    rs = np.random.RandomState(5)
    n = 3000
    v0 = (rs.rand(n, 3) * 4.0).astype(np.float32)
    e1 = (rs.randn(n, 3) * 0.1).astype(np.float32)
    e2 = (rs.randn(n, 3) * 0.1).astype(np.float32)
    mat = np.zeros(n, np.int32)
    cl, _, s2t = tclusters.build_clusters(v0, e1, e2, mat)
    flat, _, remap = tclusters.build_pages(cl, 4)
    c_pad = flat.aabb_min.shape[0]
    _equal(jclusters.remap_slot_to_tri(s2t, remap, c_pad),
           tclusters.remap_slot_to_tri(s2t, remap, c_pad), "remap")
    out = tclusters.remap_slot_to_tri(s2t, remap, c_pad)
    assert sorted(out[out >= 0].tolist()) == list(range(n))


def _rays(cam_cfg, n_side=24, seed=0):
    """Jittered camera rays of a ``n_side``² film, as numpy."""
    rs = np.random.RandomState(seed)
    s = ((np.arange(n_side * n_side) % n_side + rs.rand(n_side ** 2))
         / n_side).astype(np.float32)
    t = ((np.arange(n_side * n_side) // n_side + rs.rand(n_side ** 2))
         / n_side).astype(np.float32)
    z = jnp.zeros(n_side ** 2, jnp.float32)
    o, d = jgenerate_ray(jcamera(cam_cfg, 1.0), jnp.asarray(s),
                         jnp.asarray(t), z, z)
    return np.array(o), np.array(d)


def _attrs_close(aj, at, valid, tri, tol):
    """The attributes of both packages within ``tol`` = (normal, triangle
    uv, sphere uv, density) on valid lanes."""
    v = valid
    pairs = [(np.asarray(x), y.numpy()) for x, y in zip(aj, at)]
    (nj, nt), (uvj, uvt) = pairs[:2]
    np.testing.assert_allclose(nt[v], nj[v], atol=tol[0], rtol=0)
    np.testing.assert_allclose(uvt[v & tri], uvj[v & tri], atol=tol[1],
                               rtol=0)
    np.testing.assert_allclose(uvt[v & ~tri], uvj[v & ~tri], atol=tol[2],
                               rtol=0)
    if len(pairs) == 3:
        np.testing.assert_allclose(pairs[2][1][v], pairs[2][0][v],
                                   atol=tol[3], rtol=0)


def _port_hit(hj):
    """The port's Hit holding a JAX Hit's arrays."""
    return tscene_mod.Hit(**{f: None if getattr(hj, f) is None
                             else torch.as_tensor(np.array(getattr(hj, f)))
                             for f in tscene_mod.Hit._fields})


@pytest.mark.parametrize("name", ["textured_demo", "bump_demo",
                                  "screenlight_demo", "paged", "instanced"])
@pytest.mark.parametrize("route", ["cluster", "bvh"])
def test_prim_and_surface_attributes_match_jax(built, name, route):
    """The slot branch on the cluster routes, the prim branch on "bvh"
    (instanced scenes refuse it). ``Hit.prim`` is equal. On the JAX hit
    record both packages' attributes agree to the float noise of atan2,
    asin and log2 (measured: normals 5.4e-7, normal-mapped sphere hits of
    bump_demo; uvs 6e-8; densities 3e-8). On each package's own hits the
    hit points differ by up to 1.9e-6 (the traversals round t apart), and
    the attributes follow (measured: normals 5.8e-6, uvs 1.3e-6,
    densities 1.1e-7 relative)."""
    sj, st, cc = built[name]
    o, d = _rays(cc)
    jt, tt = (("cluster_jax", "cluster_torch") if route == "cluster"
              else ("bvh", "bvh"))
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    if route == "bvh" and name == "instanced":
        with pytest.raises(ValueError, match="instanced"):
            tscene_mod.intersect_batch(st, ot, dt, "bvh")
        return
    hj = jscene_mod.intersect_batch(sj, jnp.asarray(o), jnp.asarray(d), jt)
    ht = tscene_mod.intersect_batch(st, ot, dt, tt)
    valid, tri = np.asarray(hj.valid), np.asarray(hj.tri)
    _equal(hj.valid, ht.valid, "valid")
    _equal(hj.prim, ht.prim, "prim")
    assert (ht.slot is None) == (route == "bvh")
    assert int((ht.prim >= 0).sum()) > 50
    if name == "instanced":
        assert bool((ht.prim[ht.tri] == -1).any())    # prototype hits
    width = np.random.RandomState(1).uniform(1e-3, 0.1, o.shape[0]).astype(
        np.float32)
    hj_t = _port_hit(hj)
    for cone in (None, width):
        kj = {} if cone is None else {"cone_width": jnp.asarray(cone)}
        kt = {} if cone is None else {"cone_width": torch.as_tensor(cone)}
        aj = jscene_mod.surface_attributes(sj, hj, **kj)
        _attrs_close(aj, tscene_mod.surface_attributes(st, hj_t, **kt),
                     valid, tri, (1e-6, 1.2e-7, 1.2e-7, 6e-8))
        at = tscene_mod.surface_attributes(st, ht, **kt)
        _attrs_close(aj[:2], at[:2], valid, tri, (1e-5, 3e-6, 2e-7))
        if cone is not None:
            np.testing.assert_allclose(at[2].numpy()[valid],
                                       np.asarray(aj[2])[valid], rtol=1e-6)


def test_prim_costs_no_gather_without_attributes():
    scene, _ = tscenes.cornell_bsdf(device="cpu")
    o, d = _rays(tscenes.CORNELL_CAMERA, 8)
    hit = tscene_mod.intersect_batch(scene, torch.as_tensor(o),
                                     torch.as_tensor(d), "cluster_torch")
    assert scene.slot_to_tri is None and bool((hit.prim == -1).all())
    assert bool((hit.slot >= 0).any())


def _textured_lights(builder_cls, grid):
    """``grid``² textured emissive quads (2 rows each) and a sphere lamp."""
    b = builder_cls()
    rs = np.random.RandomState(11)
    tex = b.add_texture(rs.rand(5, 7, 3).astype(np.float32))
    tv = b.emissive((3.0, 2.0, 1.0), texture=tex)
    plain = b.emissive((1.0, 1.0, 1.0))
    for i in range(grid):
        for j in range(grid):
            b.add_quad((i * 0.5, 2.0, j * 0.5), (0.4, 0.0, 0.0),
                       (0.0, 0.0, 0.4), tv if (i + j) % 3 else plain,
                       uv=True)
    b.add_sphere((0.0, 5.0, 0.0), 0.3, plain)
    return b


@pytest.mark.parametrize("grid", [3, 11])
def test_textured_light_columns_and_sampling_match_jax(grid):
    """A small table (3²·2 + 1 rows) and a packed one (11²·2 + 1 = 243
    rows, gather mode)."""
    from pathtracing_tpu.models.scene import SceneBuilder as JBuilder

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bvh_native, "build", lambda *a, **k: None)
        lj = _textured_lights(JBuilder, grid).build().lights
    lt = _textured_lights(tscene_mod.SceneBuilder, grid).build("cpu").lights
    assert (lt.packed is not None) == (grid == 11)
    for f in ("uv0", "uv_e1", "uv_e2", "tex", "packed"):
        a, b = getattr(lj, f), getattr(lt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _equal(a, b, f)
    assert int((lt.tex >= 0).sum()) > 0 and int((lt.tex == -1).sum()) > 0
    rs = np.random.RandomState(2)
    u = rs.rand(3001, 3).astype(np.float32)
    origin = (rs.randn(3001, 3) * [2.0, 0.5, 2.0]).astype(np.float32)
    out_j = jlights.sample_solid_angle(lj, jnp.asarray(u),
                                       jnp.asarray(origin), with_uv=True)
    out_t = tlights.sample_solid_angle(lt, torch.as_tensor(u),
                                       torch.as_tensor(origin), with_uv=True)
    pj, nj, ej, pdfj, uvj, texj = (np.asarray(x) for x in out_j)
    pt, nt, et, pdft, uvt, text = (x.numpy() for x in out_t)
    _equal(texj, text, "tex")
    _equal(ej, et, "emit")
    np.testing.assert_allclose(uvt, uvj, atol=1.2e-7)
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    np.testing.assert_allclose(nt, nj, atol=3e-5)
    np.testing.assert_allclose(pdft, pdfj, rtol=1e-5)
    for a, b in zip(out_t[:4], tlights.sample_solid_angle(
            lt, torch.as_tensor(u), torch.as_tensor(origin))):
        assert torch.equal(a, b)


def test_scene_from_numpy_carries_the_attributes(built):
    for name in ("paged", "screenlight_demo", "bump_demo"):
        sj, st, _ = built[name]
        s = tscene_mod.scene_from_numpy(jax.tree.map(np.asarray, sj), "cpu")
        _scene_equal(sj, s)


RENDERS = {
    "textured_demo": 4, "bump_demo": 4, "screenlight_demo": 4,
    "textured_demo mips": 6,
}


@pytest.mark.parametrize("label", sorted(RENDERS))
def test_render_once_matches_jax(built, label):
    name = label.split()[0]
    sj, st, cc = built[name]
    if label.endswith("mips"):
        sj = sj._replace(textures=jtex.add_mips(sj.textures))
        st = st._replace(textures=ttex.add_mips(st.textures))
        assert tscene_mod.uses_mips(st)
    kw = dict(width=24, height=24, samples_per_pixel=3,
              max_depth=RENDERS[label], rr_start_depth=3, seed=1, nee=True,
              background=jscenes.preferred_background(name))
    img_j = np.asarray(jprog.render_once(
        sj, jcamera(cc, 1.0), JConfig(traversal="cluster_jax", **kw)))
    img_t = tprog.render_once(st, tcamera(cc, 1.0, device="cpu"),
                              TConfig(**kw)).numpy()
    assert img_t.shape == (24, 24, 3) and np.isfinite(img_t).all()
    diff = np.abs(img_j - img_t).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.01
    assert abs(img_t.mean() - img_j.mean()) <= 0.01 * img_j.mean()
    assert img_t.mean() > 0.05
