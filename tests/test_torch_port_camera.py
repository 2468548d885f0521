"""redner_tpu_torch's cameras against redner_tpu's on the CPU, function by
function (eager JAX, no render): ray generation, camera_to_screen and
project for all four camera types in look-at and cam_to_world modes,
Brown-Conrady distortion and its inverse with their gradients, the
intrinsic-matrix and automatic-placement helpers, and the camera patterns
of tests/test_camera.py (round trip, viewport, a triangle partly behind the
camera).  Inputs are made with numpy from fixed seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
from redner_tpu import camera as jcam
from redner_tpu_torch import camera as tcam
from tests.torch_port_util import two_torch_threads  # noqa: F401

CPU = "cpu"
TYPES = ("perspective", "orthographic", "fisheye", "panorama")
DIST = np.asarray([0.1, 0.02, 0.0, 0.0, 0.0, 0.0, 0.001, -0.002], np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _c2w():
    m = np.asarray(jcam.xf.look_at_matrix(
        jnp.asarray([0.4, 1.5, -5.0]), jnp.asarray([0.1, 0.0, 0.3]),
        jnp.asarray([0.0, 1.0, 0.1])))
    return m.astype(np.float32)


def _kwargs(kind, mode, distortion):
    kw = dict(camera_type=getattr(rt.CameraType, kind), resolution=(12, 16),
              fov=43.0)
    if mode == "look_at":
        kw.update(position=[0.4, 1.5, -5.0], look_at=[0.1, 0.0, 0.3],
                  up=[0.0, 1.0, 0.1])
    else:
        kw.update(cam_to_world=_c2w())
    if distortion:
        kw["distortion_params"] = DIST
    return kw


def _cams(kind, mode, distortion=False):
    kw = _kwargs(kind, mode, distortion)
    tkw = dict(kw, camera_type=getattr(tcam.CameraType, kind))
    return rt.make_camera(**kw), tcam.make_camera(device=CPU, **tkw)


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(_np(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode", ["look_at", "cam_to_world"])
@pytest.mark.parametrize("kind", TYPES)
def test_rays_screen_and_project(kind, mode):
    jc, tc = _cams(kind, mode)
    rng = np.random.default_rng(1)
    n = jc.height * jc.width
    jitter = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    jr, jd = jcam.sample_primary_rays(jc, jnp.asarray(jitter))
    tr, td = tcam.sample_primary_rays(tc, _t(jitter))
    _close(tr.org, jr.org)
    _close(tr.dir, jr.dir)
    # Finite differences over 1e-3 of the screen amplify f32 rounding.
    for f in ("org_dx", "org_dy", "dir_dx", "dir_dy"):
        _close(getattr(td, f), getattr(jd, f), atol=2e-5)
    if kind == "fisheye":
        dead = np.sum(np.asarray(jr.dir) ** 2, -1) == 0
        assert dead.any() and not dead.all()
        np.testing.assert_array_equal(
            np.sum(_np(tr.dir) ** 2, -1) == 0, dead)

    pts = rng.normal(0, 1.5, (64, 3)).astype(np.float32)
    js, jv, jpc = jcam.project(jc, jnp.asarray(pts))
    ts, tv, tpc = tcam.project(tc, _t(pts))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    _close(tpc, jpc)
    ok = np.asarray(jv)
    _close(_np(ts)[ok], np.asarray(js)[ok], atol=1e-5)
    jss, jsv = jcam.camera_to_screen(jc, jnp.asarray(pts))
    tss, tsv = tcam.camera_to_screen(tc, _t(pts))
    np.testing.assert_array_equal(_np(tsv), np.asarray(jsv))
    ok = np.asarray(jsv)
    _close(_np(tss)[ok], np.asarray(jss)[ok], atol=1e-5)


@pytest.mark.parametrize("kind", ["perspective", "fisheye"])
def test_distorted_camera_rays(kind):
    jc, tc = _cams(kind, "cam_to_world", distortion=True)
    screen = np.random.default_rng(2).uniform(
        0, 1, (jc.height * jc.width, 2)).astype(np.float32)
    jr = jcam.sample_primary(jc, jnp.asarray(screen))
    tr = tcam.sample_primary(tc, _t(screen))
    _close(tr.org, jr.org)
    _close(tr.dir, jr.dir, atol=2e-6)
    pts = np.random.default_rng(3).normal(0, 1.0, (32, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    js, _, _ = jcam.project(jc, jnp.asarray(pts))
    ts, _, _ = tcam.project(tc, _t(pts))
    _close(ts, js, atol=1e-5)


def test_distortion_and_inverse_gradients():
    """distort / inverse_distort values and gradients w.r.t. the screen
    position and the parameters against jax.grad where the model is
    invertible; past a fold of the model (k1 = -0.3: no inverse beyond a
    distorted radius of ~0.73) both stay finite."""
    rng = np.random.default_rng(4)
    pos = rng.uniform(0.05, 0.95, (40, 2)).astype(np.float32)
    pos[0] = [0.999, 0.998]  # outer corner: strong distortion
    w = rng.normal(0, 1, (40, 2)).astype(np.float32)
    fold = DIST.copy()
    fold[0] = -0.3
    for params, compare in ((DIST, True), (fold, False)):
        for fn_j, fn_t in ((jcam.distort, tcam.distort),
                           (jcam.inverse_distort, tcam.inverse_distort)):
            def jloss(p, x):
                out = fn_j(p, x)
                return jnp.sum(out * w), out

            (_, jout), gj = jax.value_and_grad(
                jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(params),
                                                     jnp.asarray(pos))
            pt = _t(params).requires_grad_(True)
            xt = _t(pos).requires_grad_(True)
            out = fn_t(pt, xt)
            torch.sum(out * _t(w)).backward()
            for a, b in ((out, jout), (pt.grad, gj[0]), (xt.grad, gj[1])):
                assert np.all(np.isfinite(_np(a)))
                assert np.all(np.isfinite(np.asarray(b)))
                if compare:
                    _close(a, b, rtol=1e-4, atol=1e-5)
    # Round trip inside the invertible region.
    back = tcam.distort(_t(DIST), tcam.inverse_distort(_t(DIST), _t(pos)))
    _close(back, pos, atol=1e-5)


def test_camera_leaf_gradients():
    """Gradients w.r.t. cam_to_world, intrinsic_mat and distortion_params
    through sample_primary and project, against jax.grad of a function
    that calls rt.make_camera on the same inputs."""
    rng = np.random.default_rng(5)
    c2w = _c2w()
    K = np.asarray([[1.9, 0.05, 0.02], [0.0, 2.1, -0.03], [0.0, 0.0, 1.0]],
                   np.float32)
    screen = rng.uniform(0.1, 0.9, (30, 2)).astype(np.float32)
    pts = rng.normal(0, 1.0, (30, 3)).astype(np.float32)
    wd = rng.normal(0, 1, (30, 3)).astype(np.float32)
    ws = rng.normal(0, 1, (30, 2)).astype(np.float32)
    for kind in ("perspective", "orthographic"):
        def jloss(c, k, d):
            cam = rt.make_camera(cam_to_world=c, intrinsic_mat=k,
                                 distortion_params=d, resolution=(12, 16),
                                 camera_type=getattr(rt.CameraType, kind))
            r = jcam.sample_primary(cam, jnp.asarray(screen))
            s, _, _ = jcam.project(cam, jnp.asarray(pts))
            return (jnp.sum(r.dir * wd) + jnp.sum(r.org * wd)
                    + jnp.sum(s * ws))

        gj = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(c2w), jnp.asarray(K), jnp.asarray(DIST))
        leaves = [_t(x).requires_grad_(True) for x in (c2w, K, DIST)]
        cam = tcam.make_camera(cam_to_world=leaves[0], intrinsic_mat=leaves[1],
                               distortion_params=leaves[2],
                               resolution=(12, 16), device=CPU,
                               camera_type=getattr(tcam.CameraType, kind))
        r = tcam.sample_primary(cam, _t(screen))
        s, _, _ = tcam.project(cam, _t(pts))
        (torch.sum(r.dir * _t(wd)) + torch.sum(r.org * _t(wd))
         + torch.sum(s * _t(ws))).backward()
        for a, b in zip(leaves, gj):
            _close(a.grad, b, rtol=1e-4, atol=1e-4)


def test_fov_is_derived():
    jc, tc = _cams("perspective", "look_at")
    _close(tc.fov, jc.fov)
    assert tc.cam_to_world is None and tc.position is not None
    _, tc2 = _cams("perspective", "cam_to_world")
    assert tc2.position is None and not tc2.use_look_at


def test_intrinsic_mat_and_automatic_placement():
    _close(tcam.generate_intrinsic_mat(1.5, 1.7, 0.1, 0.02, -0.03,
                                       device=CPU),
           rt.generate_intrinsic_mat(1.5, 1.7, 0.1, 0.02, -0.03))
    verts = np.random.default_rng(6).normal(0, 1, (20, 3)).astype(np.float32)
    js = rt.make_shape(vertices=verts, indices=[[0, 1, 2]])
    import redner_tpu_torch as rtt

    ts = rtt.make_shape(vertices=verts, indices=[[0, 1, 2]], device=CPU)
    jc = rt.automatic_camera_placement([js], (10, 10), fov_deg=50.0)
    tc = tcam.automatic_camera_placement([ts], (10, 10), fov_deg=50.0)
    for f in ("position", "look_at", "up", "intrinsic_mat"):
        _close(getattr(tc, f), getattr(jc, f))
    assert tc.resolution == (10, 10)


def test_project_round_trip_and_viewport():
    """project(sample_primary(p).org + t dir) returns p for every type
    (tests/test_camera.py's round trip); a viewport renders its sub-image."""
    rng = np.random.default_rng(7)
    screen = rng.uniform(0.2, 0.8, (50, 2)).astype(np.float32)
    for kind in TYPES:
        _, tc = _cams(kind, "look_at")
        ray = tcam.sample_primary(tc, _t(screen))
        p = ray.org + 2.5 * ray.dir
        s, valid, _ = tcam.project(tc, p)
        assert bool(valid.all())
        _close(s, screen, atol=2e-5)

    import redner_tpu_torch as rtt

    def scene(viewport):
        cam = rtt.make_camera(position=[0, 0, -4], look_at=[0, 0, 0],
                              up=[0, 1, 0], fov=45.0, resolution=(8, 8),
                              viewport=viewport, device=CPU)
        shape = rtt.make_shape(vertices=[[-1, -1, 0], [1, -1, 0], [0, 1, 0]],
                               indices=[[0, 2, 1]], device=CPU)
        light = rtt.generate_quad_light(position=[0, 2, -3], look_at=[0, 0, 0],
                                        size=[1, 1], intensity=[5, 5, 5],
                                        device=CPU)
        mat = rtt.make_material(diffuse_reflectance=[0.6, 0.5, 0.4],
                                device=CPU)
        return rtt.scene_from_objects(cam, [rtt.Object(shape.vertices,
                                                       shape.indices, mat),
                                            light])

    opts = rtt.RenderOptions(num_samples=2, max_bounces=1)
    full = rtt.render_image(scene(None), opts, seed=3)
    sub = rtt.render_image(scene((2, 1, 6, 7)), opts, seed=3)
    assert sub.shape == (4, 6, 3)
    assert bool(torch.isfinite(sub).all()) and float(sub.max()) > 0
    assert float(full[2:6, 1:7].max()) > 0


def test_triangle_partly_behind_camera():
    """A triangle with one vertex behind the camera projects with that
    vertex invalid, as in redner_tpu, and renders finite gradients."""
    jc, tc = _cams("perspective", "look_at")
    tri = np.asarray([[0.0, 0.0, 0.0], [0.5, 0.3, 0.5], [0.4, 1.5, -6.0]],
                     np.float32)
    js, jv, _ = jcam.project(jc, jnp.asarray(tri))
    ts, tv, _ = tcam.project(tc, _t(tri))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    assert not bool(tv.all())
