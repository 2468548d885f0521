"""redner_tpu_torch's loaders against redner_tpu's on the CPU: OBJ/MTL (with
return_objects and use_common_indices), Mitsuba serialized meshes, EXR
(uncompressed and ZIP) and the Mitsuba XML loader.  Every file is written
by the test itself.  Every loaded array, the weld maps included, equals
redner_tpu's on the same file bit for bit; a loaded Mitsuba scene renders
equal to rt.render_image of JAX's load at a matched seed."""

import struct
import zlib

import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu.io import exr as jexr
from redner_tpu_torch.io import exr as texr
from tests.torch_port_util import two_torch_threads  # noqa: F401

CPU = "cpu"


def _np(x):
    if x is None:
        return None
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(a, b, what=""):
    a, b = _np(a), _np(b)
    assert (a is None) == (b is None), what
    if a is not None:
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=what)


def _split_sphere_obj(path):
    """A small UV sphere with every face corner its own vertex, written at
    %.6g: near-duplicates the auto weld must join."""
    v, f, uv, n = rt.generate_sphere(6, 10)
    v, f, uv, n = (np.asarray(x) for x in (v, f, uv, n))
    with open(path, "w") as out:
        for c in f.reshape(-1):
            p = v[c] * 1.7 + np.asarray([0.1, -0.2, 0.3])
            out.write(f"v {p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n")
            out.write(f"vt {uv[c][0]:.6g} {uv[c][1]:.6g}\n")
            out.write(f"vn {n[c][0]:.6g} {n[c][1]:.6g} {n[c][2]:.6g}\n")
        for k in range(f.shape[0]):
            a, b, c = 3 * k + 1, 3 * k + 2, 3 * k + 3
            out.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")


def _texture(h=8, w=8, seed=0):
    return np.random.default_rng(seed).uniform(0.1, 0.9, (h, w, 3)).astype(
        np.float32)


def _two_group_obj(tmp_path):
    """An OBJ with three material groups (constant, emissive, textured), a
    quad face and shared and negative indices, and its MTL."""
    rt.imwrite(_texture(), str(tmp_path / "tex.exr"))
    (tmp_path / "m.mtl").write_text(
        "newmtl red\nKd 0.8 0.1 0.1\nKs 0.2 0.2 0.2\nNs 30\n"
        "newmtl lamp\nKd 0 0 0\nKe 5 4 3\n"
        "newmtl tex\nmap_Kd tex.exr\n")
    (tmp_path / "g.obj").write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\nv 1 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 1\nvn 0 1 0\n"
        "usemtl red\nf 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "usemtl lamp\nf -1 -2 -3\n"
        "usemtl tex\nf 1/1/2 5/2/2 6/3/2\n")
    return str(tmp_path / "g.obj")


@pytest.mark.parametrize("common", [False, True])
def test_obj_matches_jax(tmp_path, common):
    path = _two_group_obj(tmp_path)
    jm, jl, jlights = rt.load_obj(path, use_common_indices=common)
    tm, tl, tlights = rtt.load_obj(path, use_common_indices=common,
                                   device=CPU)
    assert [n for n, _ in tl] == [n for n, _ in jl] == ["red", "lamp", "tex"]
    for (name, a), (_, b) in zip(tl, jl):
        for f in a._fields:
            _same(getattr(a, f), getattr(b, f), f"{name}.{f}")
    assert sorted(tlights) == sorted(jlights) == ["lamp"]
    _same(tlights["lamp"], jlights["lamp"])
    for name in jm:
        for stack in ("diffuse_reflectance", "specular_reflectance",
                      "roughness"):
            _same(getattr(tm[name], stack).texels,
                  getattr(jm[name], stack).texels, f"{name}.{stack}")
    assert tm["tex"].diffuse_reflectance.texels.shape == (8, 8, 3)


def test_obj_split_vertices_weld_and_objects(tmp_path):
    """Per-face split vertices at %.6g: the auto weld's map equals JAX's,
    return_objects carries it, and the welded mesh keys its edges like the
    unsplit one."""
    path = str(tmp_path / "s.obj")
    _split_sphere_obj(path)
    jobj = rt.load_obj(path, return_objects=True)
    tobj = rtt.load_obj(path, return_objects=True, device=CPU)
    assert len(tobj) == len(jobj) == 1
    for f in ("vertices", "indices", "uvs", "normals", "weld_ids"):
        _same(getattr(tobj[0], f), getattr(jobj[0], f), f)
    assert tobj[0].weld_ids is not None
    assert rtt.load_obj(path, return_objects=True, weld_eps=None,
                        device=CPU)[0].weld_ids is None
    # Round trip through save_obj/save_mtl.
    out = str(tmp_path / "out.obj")
    rtt.save_obj(tobj[0], out)
    rtt.save_mtl(tobj[0].material, str(tmp_path / "out.mtl"))
    back = rtt.load_obj(out, return_objects=True, weld_eps=None, device=CPU)
    np.testing.assert_allclose(_np(back[0].vertices), _np(tobj[0].vertices),
                               rtol=1e-6)
    _same(back[0].indices, tobj[0].indices)
    assert "Kd 0.5 0.5 0.5" in (tmp_path / "out.mtl").read_text()


def test_missing_texture_raises(tmp_path):
    """The port's MTL reader raises on a texture it cannot read (the JAX
    package's drops it)."""
    (tmp_path / "m.mtl").write_text("newmtl a\nmap_Kd nowhere.exr\n")
    (tmp_path / "a.obj").write_text("mtllib m.mtl\nusemtl a\nv 0 0 0\n"
                                    "v 1 0 0\nv 0 1 0\nf 1 2 3\n")
    with pytest.raises(FileNotFoundError):
        rtt.load_obj(str(tmp_path / "a.obj"), device=CPU)


def _write_serialized(path, meshes, version):
    """Mitsuba serialized file: one zlib blob per mesh, offset table last."""
    blobs = []
    for verts, idx, normals, uvs in meshes:
        flags = 0x1000 | (0x0001 if normals is not None else 0) | \
            (0x0002 if uvs is not None else 0)
        blob = struct.pack("<I", flags)
        if version >= 4:
            blob += b"mesh\x00"
        blob += struct.pack("<QQ", verts.shape[0], idx.shape[0])
        for arr in (verts, normals, uvs):
            if arr is not None:
                blob += arr.astype(np.float32).tobytes()
        blob += idx.astype(np.uint32).tobytes()
        blobs.append(struct.pack("<HH", 0x041C, version) + zlib.compress(blob))
    offsets, pos = [], 0
    for b in blobs:
        offsets.append(pos)
        pos += len(b)
    with open(path, "wb") as f:
        for b in blobs:
            f.write(b)
        f.write(struct.pack(f"<{len(offsets)}{'Q' if version >= 4 else 'I'}",
                            *offsets))
        f.write(struct.pack("<I", len(offsets)))


def _serialized_meshes():
    rng = np.random.default_rng(1)
    a = (rng.normal(0, 1, (5, 3)), np.asarray([[0, 1, 2], [2, 3, 4]]),
         None, None)
    n = rng.normal(0, 1, (4, 3))
    b = (rng.normal(0, 1, (4, 3)), np.asarray([[0, 1, 2], [0, 2, 3]]),
         n / np.linalg.norm(n, axis=-1, keepdims=True),
         rng.uniform(0, 1, (4, 2)))
    return [a, b]


@pytest.mark.parametrize("version", [3, 4])
def test_serialized_matches_jax(tmp_path, version):
    path = str(tmp_path / "m.serialized")
    meshes = _serialized_meshes()
    _write_serialized(path, meshes, version)
    for k, (verts, idx, _, _) in enumerate(meshes):
        a = rtt.load_serialized(path, k)
        b = rt.load_serialized(path, k)
        for f in a._fields:
            _same(getattr(a, f), getattr(b, f), f)
        np.testing.assert_array_equal(a.vertices, verts.astype(np.float32))
        np.testing.assert_array_equal(a.indices, idx)


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
def test_exr_round_trip_matches_jax(tmp_path, compression):
    rng = np.random.default_rng(3)
    for shape in ((20, 9, 3), (7, 5, 4), (6, 11, 1)):
        img = rng.uniform(0.0, 2.0, shape).astype(np.float32)
        path = str(tmp_path / f"{compression}_{shape[-1]}.exr")
        texr.write_exr(path, img, compression=compression)
        with open(path, "rb") as f:
            port_bytes = f.read()
        jexr.write_exr(str(tmp_path / "j.exr"), img, compression=compression)
        with open(str(tmp_path / "j.exr"), "rb") as f:
            assert f.read() == port_bytes
        back = rtt.imread(path)
        _same(back, rt.imread(path))
        np.testing.assert_array_equal(back.reshape(shape), img)
    rtt.imwrite(torch.as_tensor(img), str(tmp_path / "t.exr"))
    np.testing.assert_array_equal(rtt.imread(str(tmp_path / "t.exr"))
                                  .reshape(img.shape), img)


def _mitsuba_files(tmp_path, res=(16, 16)):
    """A Mitsuba scene that reaches every branch the loaders share: a
    toWorld lookat sensor, a textured diffuse bsdf (EXR bitmap), a split-
    vertex OBJ sphere, a serialized mesh, a rectangle light, a cube, a
    sphere, a shapegroup instance, a point emitter and an EXR envmap."""
    rt.imwrite(_texture(16, 16, 1), str(tmp_path / "tex.exr"))
    env = np.random.default_rng(2).uniform(0.2, 1.0, (8, 16, 3)).astype(
        np.float32)
    rt.imwrite(env, str(tmp_path / "env.exr"))
    _split_sphere_obj(str(tmp_path / "ball.obj"))
    _write_serialized(str(tmp_path / "m.serialized"), _serialized_meshes(), 4)
    (tmp_path / "scene.xml").write_text(f"""<scene version="0.5.0">
  <sensor type="perspective">
    <float name="fov" value="50"/>
    <transform name="toWorld">
      <lookat origin="0.3, 1.5, -6" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="ldrfilm">
      <integer name="width" value="{res[1]}"/>
      <integer name="height" value="{res[0]}"/>
    </film>
  </sensor>
  <bsdf type="diffuse" id="textured">
    <texture type="bitmap" name="reflectance">
      <string name="filename" value="tex.exr"/>
    </texture>
  </bsdf>
  <bsdf type="roughplastic" id="plastic">
    <rgb name="diffuseReflectance" value="0.3, 0.5, 0.2"/>
    <float name="alpha" value="0.2"/>
  </bsdf>
  <shape type="obj">
    <string name="filename" value="ball.obj"/>
    <ref id="textured"/>
  </shape>
  <shape type="serialized">
    <string name="filename" value="m.serialized"/>
    <integer name="shapeIndex" value="1"/>
    <transform name="toWorld"><translate x="-2" y="0" z="1"/></transform>
    <ref id="plastic"/>
  </shape>
  <shape type="cube">
    <transform name="toWorld"><scale value="0.3"/>
      <rotate x="0" y="1" z="0" angle="30"/><translate x="1.8" y="-0.5" z="0"/>
    </transform>
    <ref id="plastic"/>
  </shape>
  <shape type="sphere">
    <point name="center" x="-1.5" y="1.2" z="0.5"/>
    <float name="radius" value="0.4"/>
  </shape>
  <shape type="shapegroup" id="grp">
    <shape type="rectangle"/>
  </shape>
  <shape type="instance">
    <ref id="grp"/>
    <transform name="toWorld"><scale x="4" y="4" z="1"/>
      <rotate x="1" y="0" z="0" angle="90"/><translate x="0" y="-1.8" z="0"/>
    </transform>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld"><rotate x="1" y="0" z="0" angle="-90"/>
      <translate x="0" y="3" z="0"/>
    </transform>
    <emitter type="area"><rgb name="radiance" value="8, 8, 8"/></emitter>
  </shape>
  <emitter type="point">
    <point name="position" x="1" y="2" z="-1"/>
    <rgb name="intensity" value="2, 2, 2"/>
  </emitter>
  <emitter type="envmap">
    <string name="filename" value="env.exr"/>
  </emitter>
</scene>""")
    return str(tmp_path / "scene.xml")


def test_mitsuba_matches_jax(tmp_path):
    path = _mitsuba_files(tmp_path)
    js = rt.load_mitsuba(path)
    ts = rtt.load_mitsuba(path, device=CPU)
    jc, tc = js.camera, ts.camera
    assert not tc.use_look_at and tc.resolution == jc.resolution
    _same(tc.cam_to_world, jc.cam_to_world)
    _same(tc.intrinsic_mat, jc.intrinsic_mat)
    assert len(ts.shapes) == len(js.shapes) == 7
    for i, (a, b) in enumerate(zip(ts.shapes, js.shapes)):
        for f in ("vertices", "indices", "uvs", "normals", "weld_ids"):
            _same(getattr(a, f), getattr(b, f), f"shape {i} {f}")
        assert (a.material_id, a.light_id) == (b.material_id, b.light_id)
    assert ts.shapes[0].weld_ids is not None  # the split sphere welded
    assert len(ts.materials) == len(js.materials)
    for a, b in zip(ts.materials, js.materials):
        for stack in ("diffuse_reflectance", "specular_reflectance",
                      "roughness"):
            _same(getattr(a, stack).texels, getattr(b, stack).texels, stack)
        assert a.two_sided == b.two_sided
    assert ts.materials[0].diffuse_reflectance.texels.shape == (16, 16, 3)
    for a, b in zip(ts.area_lights, js.area_lights):
        _same(a.intensity, b.intensity)
        assert (a.shape_id, a.two_sided) == (b.shape_id, b.two_sided)
    _same(ts.envmap.values.texels, js.envmap.values.texels)
    _same(ts.envmap.env_to_world, js.envmap.env_to_world)


def test_mitsuba_missing_mesh(tmp_path):
    (tmp_path / "s.xml").write_text("""<scene version="0.5.0">
  <sensor type="perspective"><float name="fov" value="45"/></sensor>
  <shape type="obj"><string name="filename" value="gone.obj"/></shape>
</scene>""")
    with pytest.raises(FileNotFoundError):
        rtt.load_mitsuba(str(tmp_path / "s.xml"), device=CPU)
    s = rtt.load_mitsuba(str(tmp_path / "s.xml"),
                         on_missing_mesh="placeholder", device=CPU)
    j = rt.load_mitsuba(str(tmp_path / "s.xml"), on_missing_mesh="placeholder")
    _same(s.shapes[0].vertices, j.shapes[0].vertices)


def test_mitsuba_scene_renders_like_jax(tmp_path):
    """The loaded scene through both renderers at a matched seed."""
    path = _mitsuba_files(tmp_path, res=(12, 12))
    opts = dict(num_samples=2, max_bounces=1)
    ref = np.asarray(rt.render_image(rt.load_mitsuba(path),
                                     rt.RenderOptions(**opts), seed=4))
    img = rtt.render_image(rtt.load_mitsuba(path, device=CPU),
                           rtt.RenderOptions(**opts), seed=4)
    assert ref.max() > 0
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * ref.max())
