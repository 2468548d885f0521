"""The port's edge sampling (redner_tpu_torch.edge) against redner_tpu.edge
on the CPU, plus the estimator's own checks run on the port.

Inputs are made from numpy seeds and go through both packages.  Integer
edge tables match exactly and float ones at rtol 1e-6; the primary and
secondary surrogates and their gradients match at rtol 1e-3 (atol 1e-5 x
max).  The estimator checks are the JAX suite's, with its tolerances:
the primary-edge gradient against a finite difference of the render
(tests/test_edge_sampling.py), the secondary-edge gradient at one shading
point against deterministic quadrature (same file), and the gradient of an
occluder's translation against the float64 derivative of a closed form
(tests/test_oracles.py)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu import accel as jaccel
from redner_tpu import edge as jedge
from redner_tpu.camera import sample_primary_rays as j_primary_rays
from redner_tpu.material import bsdf as j_bsdf
from redner_tpu.material import bsdf_pdf as j_bsdf_pdf
from redner_tpu.scene import fetch_local_material as j_fetch_lm
from redner_tpu_torch import accel as taccel
from redner_tpu_torch import edge as tedge
from redner_tpu_torch.camera import sample_primary_rays as t_primary_rays
from redner_tpu_torch.core.types import Ray as TRay
from redner_tpu_torch.core.types import RayDifferential as TRayDiff
from redner_tpu_torch.material import bsdf as t_bsdf
from redner_tpu_torch.material import bsdf_pdf as t_bsdf_pdf
from redner_tpu_torch.scene import fetch_local_material as t_fetch_lm
from tests.scene_util import shadow_scene, single_triangle_scene
from tests.test_edge_sampling import _P0, _L_quadrature, _soft_scene
from tests.test_oracles import _clip_topology, _pixel_center_floor_hits
from tests.torch_port_util import port_scene, two_torch_threads  # noqa: F401

# The packages export a `render` function under the render module's name.
jrender = importlib.import_module("redner_tpu.render")
trender = importlib.import_module("redner_tpu_torch.render")


def _sphere_scene():
    """A small UV sphere (seam and pole vertices duplicated, so the weld
    has work) over a quad light."""
    v, f, uv, n = rt.generate_sphere(6, 12)
    sph = rt.make_shape(vertices=v, indices=f, uvs=uv, normals=n,
                        material_id=0)
    light = rt.make_shape(
        vertices=[[-1.0, 3.0, -1.0], [1.0, 3.0, -1.0], [-1.0, 3.0, 1.0],
                  [1.0, 3.0, 1.0]],
        indices=[[0, 1, 2], [1, 3, 2]], material_id=0, light_id=0)
    cam = rt.make_camera(position=[0.0, 1.0, -4.0], look_at=[0.0, 0.0, 0.0],
                         up=[0.0, 1.0, 0.0], fov=45.0, resolution=(16, 16))
    return rt.make_scene(cam, [sph, light],
                         [rt.make_material(diffuse_reflectance=[0.5] * 3)],
                         area_lights=[rt.make_area_light(1, [10.0] * 3)])


def _flat_pair(scene):
    return (rt.flatten_scene(scene),
            rtt.flatten_scene(port_scene(scene)))


def _close(got, ref, rtol=1e-3):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-5 * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("make", [shadow_scene, _sphere_scene],
                         ids=["shadow", "sphere"])
def test_edge_tables_match_jax(make):
    jfs, tfs = _flat_pair(make())
    canon = tedge._weld_vertex_ids(tfs).numpy()
    np.testing.assert_array_equal(canon, np.asarray(jedge._weld_vertex_ids(jfs)))
    if make is _sphere_scene:
        assert (canon != np.arange(canon.shape[0])).any()  # the weld joined

    je, te = jedge.build_edges(jfs), tedge.build_edges(tfs)
    for name in ("v0", "v1", "f0", "f1", "valid"):
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(getattr(je, name)), name)

    jt, tt = jedge.build_edge_table(jfs), tedge.build_edge_table(tfs)
    np.testing.assert_array_equal(tt.slot_edge.numpy(),
                                  np.asarray(jt.slot_edge))
    for name in ("packed", "slot_packed", "cluster_center", "cluster_radius",
                 "cluster_weight"):
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert tedge._num_clusters(7) == jedge._num_clusters(7)
    assert tedge._num_clusters(47256) == jedge._num_clusters(47256)


def test_screen_helpers_match_jax():
    rng = np.random.default_rng(3)
    scene = _sphere_scene()
    jfs, tfs = _flat_pair(scene)
    je, te = jedge.build_edges(jfs), tedge.build_edges(tfs)

    # Silhouettes from the camera and from a batch of shading points.
    eye = np.float32([0.0, 1.0, -4.0])
    np.testing.assert_array_equal(
        tedge.silhouette_mask(tfs, te, torch.as_tensor(eye)).numpy(),
        np.asarray(jedge.silhouette_mask(jfs, je, jnp.asarray(eye))))
    pts = rng.normal(0, 2, (5, 1, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tedge.silhouette_mask(tfs, te, torch.as_tensor(pts)).numpy(),
        np.asarray(jedge.silhouette_mask(jfs, je, jnp.asarray(pts))))

    # Segment clipping, with flat segments and endpoints off screen.
    p0 = rng.uniform(-8, 24, (64, 2)).astype(np.float32)
    p1 = rng.uniform(-8, 24, (64, 2)).astype(np.float32)
    p1[:8, 0] = p0[:8, 0]
    p1[8:16, 1] = p0[8:16, 1]
    v0 = rng.uniform(size=64) > 0.1
    v1 = rng.uniform(size=64) > 0.1
    got = tedge._clip_segment_screen(torch.as_tensor(p0), torch.as_tensor(p1),
                                     torch.as_tensor(v0), torch.as_tensor(v1),
                                     16.0, 12.0)
    ref = jedge._clip_segment_screen(jnp.asarray(p0), jnp.asarray(p1),
                                     jnp.asarray(v0), jnp.asarray(v1),
                                     16.0, 12.0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    ok = np.asarray(ref[2])
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy()[ok], np.asarray(r)[ok],
                                   rtol=1e-5, atol=1e-5)

    # Projection to pixels, points behind the camera included.
    pw = rng.normal(0, 3, (128, 3)).astype(np.float32)
    gp, gv = tedge.project_pixels(port_scene(scene).camera, torch.as_tensor(pw))
    rp, rv = jedge.project_pixels(scene.camera, jnp.asarray(pw))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_allclose(gp.numpy(), np.asarray(rp), rtol=1e-5,
                               atol=1e-4)

    # The firefly clamp: zeros, a spike and ordinary lanes.
    z = np.abs(rng.standard_cauchy(4096)).astype(np.float32)
    z[::3] = 0.0
    z[7] = 1e6
    np.testing.assert_allclose(
        tedge.firefly_scale(torch.as_tensor(z), 50.0).numpy(),
        np.asarray(jedge.firefly_scale(jnp.asarray(z), 50.0)), rtol=1e-6)


def test_primary_edge_gradients_match_jax(monkeypatch):
    """Surrogate gradient w.r.t. every vertex and the camera position at a
    matched seed.  A 256-lane evaluation chunk makes the 600 offset rays
    run as three chunks, the last one padded, in both packages."""
    monkeypatch.setattr(jedge, "EDGE_EVAL_CHUNK", 256)
    monkeypatch.setattr(tedge, "EDGE_EVAL_CHUNK", 256)
    n_edge, seed = 300, 5
    scene = shadow_scene(res=(16, 16))
    d_image = np.random.default_rng(1).uniform(0.5, 1.5, (16, 16, 3)).astype(
        np.float32)
    opts = dict(num_samples=1, max_bounces=1)

    def jsurr(verts, cam_pos):
        s = scene.replace(
            shapes=tuple(sh.replace(vertices=v)
                         for sh, v in zip(scene.shapes, verts)),
            camera=scene.camera.replace(position=cam_pos))
        return jedge.primary_edge_gradients(
            s, rt.flatten_scene, jrender.render_sample,
            rt.RenderOptions(**opts), jnp.uint32(seed), jnp.asarray(d_image),
            n_edge)

    jval, (g_verts, g_pos) = jax.jit(jax.value_and_grad(jsurr, (0, 1)))(
        tuple(s.vertices for s in scene.shapes), scene.camera.position)

    ts = port_scene(scene)
    leaves = [s.vertices for s in ts.shapes] + [ts.camera.position]
    for x in leaves:
        x.requires_grad_(True)
    val = tedge.primary_edge_gradients(
        ts, rtt.flatten_scene, trender.render_sample,
        rtt.RenderOptions(**opts), seed, torch.as_tensor(d_image), n_edge)
    val.backward()
    assert abs(float(jval)) > 0
    _close(val, jval)
    for s, g in zip(ts.shapes, g_verts):
        _close(s.vertices.grad, g)
    _close(ts.camera.position.grad, g_pos)
    assert np.abs(np.asarray(g_pos)).max() > 0


def _shading_lanes_jax(scene, jitter):
    fs = rt.flatten_scene(scene)
    ray, rd = j_primary_rays(scene.camera, jnp.asarray(jitter))
    isect = jaccel.intersect(fs, ray)
    sp, _ = jrender._surface_point_at(fs, isect, ray, rd)
    mid = fs.face_material_id[jnp.clip(isect.tri_id, 0, fs.num_triangles - 1)]
    return fs, ray, isect, sp, j_fetch_lm(fs, sp, mid)


def _shading_lanes_torch(tscene, jitter):
    fs = rtt.flatten_scene(tscene)
    ray, rd = t_primary_rays(tscene.camera, torch.as_tensor(jitter))
    isect = taccel.intersect(fs, ray)
    sp, _ = trender._surface_point_at(fs, isect, ray, rd)
    mid = fs.face_material_id[torch.clamp(isect.tri_id, 0,
                                          fs.num_triangles - 1)]
    return fs, ray, isect, sp, t_fetch_lm(fs, sp, mid)


def test_secondary_edge_surrogate_matches_jax():
    """One pass of shadow_scene's camera-ray lanes through the surrogate
    with every importance input (NEE and mirror directions, shading
    normals, the light-rim MIS split): value and gradients w.r.t. the
    shading points and every vertex."""
    rng = np.random.default_rng(2)
    scene = shadow_scene(res=(16, 16))
    P = 256
    jitter = rng.uniform(0, 1, (P, 2)).astype(np.float32)
    d_pixel = rng.uniform(0.5, 1.5, (P, 3)).astype(np.float32)
    sample_id = np.full(P, 3, np.uint32)
    lane_ids = rng.permutation(P).astype(np.int32)
    seed = 9
    opts = dict(num_samples=1, max_bounces=1)

    jfs, jray, jisect, jsp, jlm = _shading_lanes_jax(scene, jitter)
    p_np = np.asarray(jsp.position)
    n_np = np.asarray(jsp.frame_n)
    wi_np = -np.asarray(jray.dir)
    nee = np.float32([0.0, 3.0, 0.2]) - p_np
    nee /= np.linalg.norm(nee, axis=-1, keepdims=True)
    refl = 2.0 * np.sum(wi_np * n_np, -1, keepdims=True) * n_np - wi_np
    sigma = np.full(P, 0.3, np.float32)
    weight = np.full(P, 2.0, np.float32)
    min_rough = jnp.zeros(P)

    def jsurr(sp_pos, verts):
        fs = rt.flatten_scene(scene.replace(shapes=tuple(
            sh.replace(vertices=v) for sh, v in zip(scene.shapes, verts))))
        return jedge.secondary_edge_surrogate(
            fs, rt.RenderOptions(**opts), jnp.uint32(seed),
            jnp.asarray(sample_id), sp_pos, jnp.asarray(wi_np),
            lambda wo: j_bsdf(jlm, jsp, jnp.asarray(wi_np), wo,
                                        min_rough),
            jrender.trace_radiance, jnp.asarray(d_pixel), jisect.valid,
            nee_dir=jnp.asarray(nee), dim_base=132,
            bsdf_pdf_fn=lambda wo: j_bsdf_pdf(
                jlm, jsp, jnp.asarray(wi_np), wo, min_rough),
            specular_dir=jnp.asarray(refl), specular_sigma=jnp.asarray(sigma),
            specular_weight=jnp.asarray(weight),
            lane_ids=jnp.asarray(lane_ids),
            edge_table=jedge.build_edge_table(fs),
            shading_normal=jnp.asarray(n_np))

    jval, (g_p, g_verts) = jax.jit(jax.value_and_grad(jsurr, (0, 1)))(
        jsp.position, tuple(s.vertices for s in scene.shapes))

    ts = port_scene(scene)
    tfs, tray, tisect, tsp, tlm = _shading_lanes_torch(ts, jitter)
    for s in ts.shapes:
        s.vertices.requires_grad_(True)
    tfs = rtt.flatten_scene(ts)  # vertices now carry grad
    sp_pos = tsp.position.detach().clone().requires_grad_(True)
    wi = torch.as_tensor(wi_np)
    mr = torch.zeros(P)
    t = lambda x: torch.as_tensor(np.array(x))
    val = tedge.secondary_edge_surrogate(
        tfs, rtt.RenderOptions(**opts), seed, t(sample_id.astype(np.int64)),
        sp_pos, wi, lambda wo: t_bsdf(tlm, tsp, wi, wo, mr),
        trender.trace_radiance, t(d_pixel), tisect.valid, nee_dir=t(nee),
        dim_base=132, bsdf_pdf_fn=lambda wo: t_bsdf_pdf(tlm, tsp, wi, wo, mr),
        specular_dir=t(refl), specular_sigma=t(sigma), specular_weight=t(weight),
        lane_ids=t(lane_ids.astype(np.int64)),
        edge_table=tedge.build_edge_table(tfs), shading_normal=t(n_np))
    val.backward()
    # The value is zero up to rounding (n_hat is orthogonal to omega); the
    # estimator is the gradient.
    assert abs(float(val.detach()) - float(jval)) < 1e-4
    _close(sp_pos.grad, g_p)
    assert np.abs(np.asarray(g_p)).max() > 0
    for s, g in zip(ts.shapes, g_verts):
        _close(s.vertices.grad, g)
    assert np.abs(np.asarray(g_verts[1])).max() > 0  # the blocker's


# ----------------------------------------------------------------------
# The estimator's own checks (tests/test_edge_sampling.py), on the port
# ----------------------------------------------------------------------


def test_primary_edge_gradient_matches_fd():
    ts = port_scene(single_triangle_scene(res=(16, 16)))
    tri = ts.shapes[0]

    def loss(tx, use_edge=True):
        o = rtt.RenderOptions(num_samples=16, max_bounces=1,
                              use_primary_edge_sampling=use_edge,
                              use_secondary_edge_sampling=use_edge)
        v = tri.vertices + torch.stack([tx, tx * 0, tx * 0])
        s = dataclasses.replace(
            ts, shapes=(dataclasses.replace(tri, vertices=v),) + ts.shapes[1:])
        return torch.sum(rtt.render(s, o, seed=0))

    def grad(use_edge):
        tx = torch.zeros((), requires_grad=True)
        loss(tx, use_edge).backward()
        return float(tx.grad)

    g_edge, g_noedge = grad(True), grad(False)
    eps = 0.02
    with torch.no_grad():
        fd = float(loss(torch.tensor(eps)) - loss(torch.tensor(-eps))) / (2 * eps)
    # AD alone misses the silhouette term entirely.
    assert abs(g_noedge) < 0.05 * abs(fd)
    assert abs(g_edge - fd) <= 0.35 * abs(fd), (g_edge, fd)


def test_secondary_edge_unbiased_single_point():
    eps = 0.02
    # x3: the estimator sums the RGB channels (equal here).
    gt = 3.0 * (_L_quadrature(eps) - _L_quadrature(-eps)) / (2 * eps)

    ts = port_scene(_soft_scene())
    fs = rtt.flatten_scene(ts)
    options = rtt.RenderOptions(num_samples=1, max_bounces=1)
    NL = 4096
    p = torch.as_tensor(np.float32(_P0)).expand(NL, 3)
    ray = TRay(org=p + torch.tensor([0.0, 1.0, 0.0]),
               dir=torch.tensor([0.0, -1.0, 0.0]).expand(NL, 3),
               tmin=torch.zeros(NL), tmax=torch.full((NL,), float("inf")))
    isect = taccel.intersect(fs, ray)
    sp, _ = trender._surface_point_at(fs, isect, ray, TRayDiff.zero((NL,)))
    mid = fs.face_material_id[torch.clamp(isect.tri_id, 0,
                                          fs.num_triangles - 1)]
    lm = t_fetch_lm(fs, sp, mid)
    wi = -ray.dir
    min_rough = torch.zeros(NL)
    blocker = ts.shapes[1]

    def grad_dx(seed):
        dx = torch.zeros((), requires_grad=True)
        v = blocker.vertices + torch.stack([dx, dx * 0, dx * 0])
        fs2 = rtt.flatten_scene(dataclasses.replace(ts, shapes=(
            ts.shapes[0], dataclasses.replace(blocker, vertices=v),
            ts.shapes[2])))
        s = tedge.secondary_edge_surrogate(
            fs2, options, seed, 0, sp.position, wi,
            lambda wo: t_bsdf(lm, sp, wi, wo, min_rough),
            trender.trace_radiance, torch.ones((NL, 3)), isect.valid) / NL
        s.backward()
        return float(dx.grad)

    est = np.mean([grad_dx(s) for s in range(3)])
    assert np.isfinite(est)
    assert abs(est - gt) < 0.25 * abs(gt), (est, gt)


# ----------------------------------------------------------------------
# The analytic occluder oracle (tests/test_oracles.py), on the port
# ----------------------------------------------------------------------


def _polygon_irradiance_t(p, n, verts, L):
    """tests/test_oracles.py's contour formula in float64 torch."""
    v = verts - p[None, :]
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    b = torch.roll(v, -1, dims=0)
    cr = torch.cross(v, b, dim=-1)
    s = torch.clamp_min(torch.linalg.norm(cr, dim=-1), 1e-30)
    theta = torch.atan2(s, torch.sum(v * b, dim=-1))
    return L / 2.0 * torch.sum(theta * ((cr / s[:, None]) @ n))


def _clip_build_t(toks, verts, c, d):
    pts = []
    for t in toks:
        if t[0] == "v":
            pts.append(verts[t[1]])
        else:
            a, b = verts[t[1]], verts[t[2]]
            sa, sb = torch.dot(a - c, d), torch.dot(b - c, d)
            pts.append(a + sa / (sa - sb) * (b - a))
    return torch.stack(pts)


def test_occluder_translation_gradient_matches_analytic():
    """d/dtx of the image sum as a half-plane occluder slides across a
    square light, against the float64 derivative of the clipped-polygon
    contour formula.  AD alone gives zero here, so this isolates the
    port's secondary-edge estimator."""
    L, res = 5.0, 16
    light_y, half = 3.0, 1.0
    y_o, occ_x0 = light_y / 2.0, -0.2
    cpu = dict(device="cpu")
    cam = rtt.make_camera(position=[0.0, 1.0, -6.0], look_at=[0.0, 0.0, 0.0],
                          up=[0.0, 1.0, 0.0], fov=18.0, resolution=(res, res),
                          **cpu)
    floor = rtt.make_shape(
        vertices=[[-8.0, 0.0, -8.0], [8.0, 0.0, -8.0], [-8.0, 0.0, 8.0],
                  [8.0, 0.0, 8.0]], indices=[[0, 2, 1], [1, 2, 3]],
        material_id=0, **cpu)
    light = rtt.make_shape(
        vertices=[[-half, light_y, -half], [half, light_y, -half],
                  [-half, light_y, half], [half, light_y, half]],
        indices=[[0, 1, 2], [1, 3, 2]], material_id=0, light_id=0, **cpu)
    base = torch.tensor([[occ_x0, y_o, -6.0], [6.0, y_o, -6.0],
                         [occ_x0, y_o, 6.0], [6.0, y_o, 6.0]])
    occ = rtt.make_shape(vertices=base, indices=[[0, 1, 2], [1, 3, 2]],
                         material_id=0, **cpu)
    scene = rtt.make_scene(
        cam, [floor, light, occ],
        [rtt.make_material(diffuse_reflectance=[0.7] * 3, **cpu)],
        area_lights=[rtt.make_area_light(1, [L] * 3, two_sided=True,
                                         directly_visible=False, **cpu)])
    opts = rtt.RenderOptions(num_samples=16, max_bounces=1,
                             use_primary_edge_sampling=False)
    # Only the two edge vertices move (the far side is parked away).
    moving = torch.tensor([[1.0], [0.0], [1.0], [0.0]])

    def grad(seed):
        tx = torch.zeros((), requires_grad=True)
        v = base + torch.stack([tx, tx * 0, tx * 0]) * moving
        s = dataclasses.replace(
            scene, shapes=(floor, light, dataclasses.replace(occ, vertices=v)))
        torch.sum(rtt.render(s, opts, seed=seed)).backward()
        return float(tx.grad)

    seeds = 24
    gs = np.array([grad(s) for s in range(seeds)])

    # Float64 oracle: per-pixel clip topology fixed at tx = 0 (locally
    # constant in tx), the clipped light polygon rebuilt differentiably.
    hits = _pixel_center_floor_hits([0.0, 1.0, -6.0], [0.0, 0.0, 0.0],
                                    18.0, res)
    loop = np.array([[-half, light_y, -half], [half, light_y, -half],
                     [half, light_y, half], [-half, light_y, half]])
    e0_np = np.array([occ_x0, y_o, 0.0])
    e1_np = e0_np + np.array([0.0, 0.0, 1.0])
    tx = torch.zeros((), dtype=torch.float64, requires_grad=True)
    off = torch.stack([tx, tx * 0, tx * 0])
    n_up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64)
    lt = torch.as_tensor(loop)
    tot = torch.zeros((), dtype=torch.float64)
    for p_np in hits.reshape(-1, 3):
        nrm_np = np.cross(e1_np - e0_np, e0_np - p_np)
        q0 = loop[0]
        x_cross = p_np[0] + (y_o - p_np[1]) / (q0[1] - p_np[1]) * (
            q0[0] - p_np[0])
        sgn = 1.0 if (np.dot(q0 - e0_np, nrm_np) > 0) == (x_cross < occ_x0) \
            else -1.0
        toks = _clip_topology(loop, e0_np, nrm_np * sgn)
        if not toks:
            continue  # fully blocked
        p = torch.as_tensor(p_np)
        e0 = torch.as_tensor(e0_np) + off
        e1 = e0 + torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
        nrm = torch.cross(e1 - e0, e0 - p, dim=-1)
        poly = _clip_build_t(toks, lt, e0, nrm * sgn)
        tot = tot + 0.7 / np.pi * torch.abs(
            _polygon_irradiance_t(p, n_up, poly, L))
    (3.0 * tot).backward()  # the loss sums 3 equal RGB channels
    g_exact = float(tx.grad)

    se = gs.std() / np.sqrt(seeds)
    assert g_exact != 0.0
    tol = max(3.0 * se, 0.10 * abs(g_exact))
    assert abs(gs.mean() - g_exact) < tol, (gs.mean(), g_exact, se, gs.std())
