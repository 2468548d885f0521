"""The port's `bruteforce` and `cluster` engine names on the CPU: they run
the plain queries, which return the hits of redner_tpu's
intersect_bruteforce / occluded_bruteforce and
ops.cluster.intersect_clustered / occluded_clustered on the same rays (ids
equal, t within rtol 1e-5) on a scene of 4,830 triangles (19 of the JAX
engine's clusters of 256); render_image through each name against the
default engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu import accel as jaccel
from redner_tpu.core.types import Ray
from redner_tpu.ops import cluster as jcluster
from redner_tpu.scene import flatten_scene as jflatten
from redner_tpu_torch import accel as taccel
from redner_tpu_torch.scene import flatten_scene as tflatten
from tests.torch_port_util import (port_ray, port_scene,  # noqa: F401
                                   two_torch_threads)

ENGINES = ("bruteforce", "cluster")
JAX_QUERIES = {
    ("bruteforce", "closest"): jaccel.intersect_bruteforce,
    ("bruteforce", "any"): jaccel.occluded_bruteforce,
    ("cluster", "closest"): jcluster.intersect_clustered,
    ("cluster", "any"): jcluster.occluded_clustered,
}


def _scene(res=(8, 8)):
    """A 4,828-triangle sphere, a floor quad and a quad light."""
    v, f, uv, nrm = rt.generate_sphere(36, 72)
    cam = rt.make_camera(position=[0.0, 1.5, -4.0], look_at=[0.0, 0.0, 0.0],
                         up=[0.0, 1.0, 0.0], fov=45.0, resolution=res)
    sphere = rt.make_shape(vertices=v, indices=f, uvs=uv, normals=nrm)
    floor = rt.make_shape(
        vertices=[[-4.0, -1.0, -4.0], [4.0, -1.0, -4.0], [-4.0, -1.0, 4.0],
                  [4.0, -1.0, 4.0]],
        indices=[[0, 2, 1], [1, 2, 3]])
    light = rt.make_shape(
        vertices=[[-0.5, 3.0, -0.3], [0.5, 3.0, -0.3], [-0.5, 3.0, 0.7],
                  [0.5, 3.0, 0.7]],
        indices=[[0, 1, 2], [1, 3, 2]], light_id=0)
    mat = rt.make_material(diffuse_reflectance=[0.5, 0.5, 0.5])
    return rt.make_scene(cam, [sphere, floor, light], [mat],
                         [rt.make_area_light(2, [30.0, 30.0, 30.0])])


def _rays(fs, n=768, seed=0):
    """Random rays, rays from points on the geometry (bounce and shadow
    style) and a few dead lanes (zero direction), with finite tmax on a
    third of them."""
    rng = np.random.default_rng(seed)
    f = np.asarray(fs.faces)
    v = np.asarray(fs.vertices)
    tri = rng.integers(0, f.shape[0], n // 2)
    b = rng.dirichlet([1.0, 1.0, 1.0], n // 2).astype(np.float32)
    on_geo = sum(b[:, k:k + 1] * v[f[tri, k]] for k in range(3))
    org = np.concatenate([rng.normal(0, 3, (n - n // 2, 3)), on_geo])
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4] = 0.0
    tmax = np.where(np.arange(n) % 3 == 0, rng.uniform(0.2, 4.0, n), np.inf)
    return Ray(org=jnp.asarray(org, jnp.float32),
               dir=jnp.asarray(d, jnp.float32),
               tmin=jnp.full((n,), 1e-3, jnp.float32),
               tmax=jnp.asarray(tmax, jnp.float32))


@pytest.fixture(scope="module")
def scenes():
    scene = _scene()
    fs = jflatten(scene)
    tfs = tflatten(port_scene(scene))
    ray = _rays(fs)
    return fs, tfs, ray, port_ray(ray)


def _same_hits(a_ids, a_t, b_ids, b_t, atol=0.0):
    np.testing.assert_array_equal(a_ids, b_ids)
    hit = a_ids >= 0
    assert hit.sum() > 100
    np.testing.assert_allclose(a_t[hit], b_t[hit], rtol=1e-5, atol=atol)
    assert np.all(np.isinf(a_t[~hit])) and np.all(np.isinf(b_t[~hit]))


@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("engine", ENGINES)
def test_engines_match_jax(scenes, engine, query):
    """JAX's bruteforce computes t as (e2 . q) / det, the port's plain
    queries (as JAX's cluster engine) as t_num / |det| from the coefficient
    forms: near-surface hits (t ~ 1e-2) then differ by a few ulp of the
    scene's coordinates, hence atol 1e-5 against bruteforce."""
    fs, tfs, ray, tray = scenes
    ref = JAX_QUERIES[engine, query](fs, ray)
    if query == "closest":
        got = taccel.intersect(tfs, tray, engine=engine)
        _same_hits(np.asarray(ref.tri_id), np.asarray(ref.t),
                   got.tri_id.numpy(), got.t.numpy(),
                   atol=1e-5 if engine == "bruteforce" else 0.0)
        np.testing.assert_array_equal(np.asarray(ref.shape_id),
                                      got.shape_id.numpy())
    else:
        got = taccel.occluded(tfs, tray, engine=engine)
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())
        assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("engine", ENGINES)
def test_engines_match_plain_queries(scenes, engine):
    """Each name runs the plain queries: the same records, bit for bit."""
    _, tfs, _, tray = scenes
    assert tfs.num_triangles > 1024
    ref = taccel.intersect(tfs, tray, engine="plain")
    got = taccel.intersect(tfs, tray, engine=engine)
    for a, b in zip((ref.tri_id, ref.shape_id, ref.t),
                    (got.tri_id, got.shape_id, got.t)):
        assert torch.equal(a, b)
    assert torch.equal(taccel.occluded(tfs, tray, engine="plain"),
                       taccel.occluded(tfs, tray, engine=engine))


@pytest.mark.parametrize("engine", ENGINES)
def test_render_image_through_each_engine(engine):
    tscene = port_scene(_scene(res=(12, 12)))
    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    with torch.no_grad():
        ref = rtt.render_image(tscene, opts, seed=3)
        got = rtt.render_image(tscene, opts, seed=3, engine=engine)
    assert float(ref.max()) > 0
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-6 * float(ref.max()))


def test_unknown_engine_raises(scenes):
    _, tfs, _, tray = scenes
    with pytest.raises(ValueError, match="unknown engine"):
        taccel.intersect(tfs, tray, engine="bvh")
