"""redner_tpu_torch's mesh helpers against redner_tpu's on the CPU: welds,
UV seams, atlas UVs and the fast OBJ scan equal to the reference helper's
output (the same native/meshops.cpp, built by the port into its own
_build/); vertex normals, smoothing and bounds against JAX with their
gradients; the load-time weld restoring the boundary-edge count through
Shape.weld_ids; and the geometry image."""

from itertools import product

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu import geometry as jgeo
from redner_tpu import meshops as jmeshops
from redner_tpu.geometry_images import generate_geometry_image as jgim
from redner_tpu_torch import edge as tedge
from redner_tpu_torch import geometry as tgeo
from redner_tpu_torch import meshops as tmeshops
from tests.torch_port_util import two_torch_threads  # noqa: F401

CPU = "cpu"


def _cube():
    corners = np.asarray(list(product([0, 1], repeat=3)), np.float32)
    faces = []
    for a, b, c, d in [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
                       (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]:
        faces += [[a, b, c], [a, c, d]]
    return corners, np.asarray(faces, np.int32)


def _split(v, f, amp=2e-7, seed=0):
    """Every face corner its own vertex, perturbed by ~amp (below the auto
    weld eps of 1e-6 x bbox diagonal, above bit-identity)."""
    rng = np.random.default_rng(seed)
    verts = v[f.reshape(-1)] + rng.uniform(-amp, amp, (f.size, 3)).astype(
        np.float32)
    return verts.astype(np.float32), np.arange(f.size, dtype=np.int32
                                               ).reshape(f.shape)


def test_library_builds_into_the_port():
    path = tmeshops.build()
    assert path.parent == tmeshops.BUILD_DIR and path.exists()
    assert path.parent.name == "_build"


def test_welds_match_reference():
    v, f = _cube()
    sv, sf = _split(v, f)
    uv = np.random.default_rng(1).uniform(0, 1, (sv.shape[0], 2)).astype(
        np.float32)
    uv[1::2] = uv[0::2]  # half the corners share their neighbour's uv
    for eps in (1e-5, 1e-3):
        for uvs in (None, uv):
            a = tmeshops.weld_mesh(sv, sf, uvs=uvs, eps=eps)
            b = jmeshops.weld_mesh(sv, sf, uvs=uvs, eps=eps)
            for x, y in zip(a, b):
                if y is None:
                    assert x is None
                else:
                    np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(tmeshops.weld_ids(sv, eps),
                                      jmeshops.weld_ids(sv, eps))
    new_v, _, _ = tmeshops.weld_mesh(sv, sf, eps=1e-5)
    assert new_v.shape[0] == 8
    # A uv seam keeps two coincident vertices apart.
    same = np.zeros((2, 3), np.float32)
    seam = np.asarray([[0, 0], [0.5, 0.5]], np.float32)
    assert tmeshops.weld_mesh(same, [[0, 1, 0]], uvs=seam,
                              eps=1e-5)[0].shape[0] == 2


def test_atlas_uvs_and_fast_obj_match_reference(tmp_path):
    v, f = _cube()
    a = tmeshops.compute_uvs(v, f)
    b = jmeshops.compute_uvs(v, f)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    sv, sf, suv, _ = (np.asarray(x) for x in rt.generate_sphere(6, 10))
    for thr in (0.5, 0.9):
        for x, y in zip(tmeshops.compute_uvs(sv, sf, thr),
                        jmeshops.compute_uvs(sv, sf, thr)):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="out of range"):
        tmeshops.compute_uvs(v, f + 1)  # the native code reads no further
    shape = tgeo.compute_uvs(rtt.make_shape(vertices=v, indices=f,
                                            device=CPU))
    np.testing.assert_array_equal(shape.uvs.numpy(), a[0])
    np.testing.assert_array_equal(shape.uv_indices.numpy(), a[1])

    path = str(tmp_path / "m.obj")
    with open(path, "w") as out:
        out.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n")
        out.write("f 1 2 3\nf 2/1 4/2 3/3\nf 1 2 3 4\n")
    for x, y in zip(tmeshops.load_obj_fast(path),
                    jmeshops.load_obj_fast(path)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("scheme", ["max", "cotangent"])
def test_vertex_normals_match_jax(scheme):
    v, f, _, _ = (np.array(x) for x in rt.generate_sphere(8, 16))
    v = v * np.random.default_rng(2).uniform(0.9, 1.1, (v.shape[0], 1)
                                             ).astype(np.float32)
    w = np.random.default_rng(3).normal(0, 1, v.shape).astype(np.float32)
    ref, g_ref = jax.value_and_grad(
        lambda x: jnp.sum(jgeo.compute_vertex_normal(x, jnp.asarray(f),
                                                     scheme) * w))(
        jnp.asarray(v))
    vt = torch.as_tensor(v).requires_grad_(True)
    n = tgeo.compute_vertex_normal(vt, torch.as_tensor(f), scheme)
    loss = torch.sum(n * torch.as_tensor(w))
    loss.backward()
    # The cotangent scheme sums cancelling 1/tan terms: ulp differences of
    # the two packages' angles show at ~5e-5.
    np.testing.assert_allclose(
        n.detach().numpy(),
        np.asarray(jgeo.compute_vertex_normal(jnp.asarray(v), jnp.asarray(f),
                                              scheme)),
        rtol=1e-4, atol=1e-5)
    assert abs(float(loss.detach()) - float(ref)) < 1e-3
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(g_ref), rtol=1e-3,
                               atol=1e-4)
    # A degenerate face stays finite, as in JAX.
    d = tgeo.compute_vertex_normal(torch.zeros((3, 3)), [[0, 1, 2]], scheme)
    assert bool(torch.isfinite(d).all())


def test_smooth_and_bounds_match_jax():
    v, f, _, _ = (np.array(x) for x in rt.generate_sphere(8, 16))
    v[40] *= 1.5
    w = np.random.default_rng(4).normal(0, 1, v.shape).astype(np.float32)
    ref, g_ref = jax.value_and_grad(
        lambda x: jnp.sum(jgeo.smooth(x, jnp.asarray(f), 0.3) * w))(
        jnp.asarray(v))
    vt = torch.as_tensor(v).requires_grad_(True)
    sm = tgeo.smooth(vt, torch.as_tensor(f), 0.3)
    torch.sum(sm * torch.as_tensor(w)).backward()
    np.testing.assert_allclose(
        sm.detach().numpy(),
        np.asarray(jgeo.smooth(jnp.asarray(v), jnp.asarray(f), 0.3)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-6)
    assert float(sm[40].detach().norm()) < float(np.linalg.norm(v[40]))
    c, r = tgeo.bound_vertices(torch.as_tensor(v))
    jc, jr = jgeo.bound_vertices(jnp.asarray(v))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(r), float(jr), rtol=1e-6)


def _boundary(shape):
    cam = rtt.make_camera(position=[0.0, 3.0, -6.0], look_at=[0.0, 0.0, 0.0],
                          up=[0.0, 1.0, 0.0], fov=45.0, resolution=(4, 4),
                          device=CPU)
    scene = rtt.make_scene(cam, [shape], [rtt.make_material(
        diffuse_reflectance=[0.5] * 3, device=CPU)])
    e = tedge.build_edges(rtt.flatten_scene(scene))
    return int((e.valid & (e.f1 < 0)).sum()), int(e.valid.sum())


def _write_obj(path, v, f):
    with open(path, "w") as out:
        for p in v:
            out.write(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        for face in f:
            out.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def test_weld_restores_boundary_count(tmp_path):
    """A perturbed split-vertex mesh from an OBJ keys its edges like the
    unsplit mesh's load once its load-time weld map is on the Shape;
    without it every edge is a boundary (tests/test_weld_load.py on the
    port)."""
    v, f, _, _ = (np.asarray(x) for x in rt.generate_sphere(6, 10))
    _write_obj(tmp_path / "split.obj", *_split(v, f))
    _write_obj(tmp_path / "whole.obj", v, f)
    obj = rtt.load_obj(str(tmp_path / "split.obj"), return_objects=True,
                       device=CPU)[0]
    whole = rtt.load_obj(str(tmp_path / "whole.obj"), return_objects=True,
                         device=CPU)[0]
    assert obj.weld_ids is not None
    np.testing.assert_array_equal(
        obj.weld_ids.numpy(),
        rt.load_obj(str(tmp_path / "split.obj"), return_objects=True)[0]
        .weld_ids)

    def shape(o, weld=True):
        return rtt.make_shape(vertices=o.vertices, indices=o.indices,
                              weld_ids=o.weld_ids if weld else None,
                              device=CPU)

    welded, reference = _boundary(shape(obj)), _boundary(shape(whole))
    unwelded = _boundary(shape(obj, weld=False))
    assert welded == reference
    assert unwelded[0] == unwelded[1] > reference[0]
    # Through Object -> scene_from_objects the map composes the same way.
    cam = rtt.make_camera(position=[0, 0, -5], look_at=[0, 0, 0], up=[0, 1, 0],
                          fov=45.0, resolution=(4, 4), device=CPU)
    fs = rtt.flatten_scene(rtt.scene_from_objects(cam, [obj]))
    assert fs.weld_ids is not None
    e = tedge.build_edges(fs)
    assert int((e.valid & (e.f1 < 0)).sum()) == reference[0]


@pytest.mark.parametrize("size", [1, 3, 8])
def test_geometry_image_matches_jax(size):
    for a, b in zip(rtt.generate_geometry_image(size, device=CPU),
                    jgim(size)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
