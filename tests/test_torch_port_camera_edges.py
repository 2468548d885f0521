"""Primary-edge gradients under nonlinear and orthographic cameras:
redner_tpu_torch.render against jax.grad of redner_tpu.render on the CPU at
a matched seed, leaf for leaf: the occluder's vertices, cam_to_world,
intrinsic_mat and (distorted camera) distortion_params, where the JAX
function builds its camera with rt.make_camera from those inputs.

The render is radiance with 0 bounces and primary edges only (secondary
edge sampling off), 8x8, 4 spp: a dark triangle in front of a bright
two-sided quad light, so every visibility gradient is a primary edge's.
Under fisheye and distortion the edges image to arcs (the film-arc
branch); the orthographic camera has its viewpoint at infinity.  Three
JAX compiles in two tests: the lane's workers take a file of few tests
after the files of many."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from tests.torch_port_util import port_scene, two_torch_threads  # noqa: F401

SEED = 7
RES = (8, 8)
OPTS = dict(num_samples=4, max_bounces=0, use_secondary_edge_sampling=False)
CAMERAS = {
    # name: (camera type, eye z, intrinsic matrix or None, distortion)
    "fisheye": ("fisheye", -1.0, None, None),
    # A diagonal matrix: an orthographic camera's third column shifts its
    # projection by depth but not its rays (redner_tpu/camera.py:262-269
    # vs :370-375), so an off-centre one would move the edges off the image.
    "orthographic": ("orthographic", -3.0,
                     [[1.1, 0.0, 0.0], [0.0, 1.2, 0.0], [0.0, 0.0, 1.0]],
                     None),
    "distorted": ("perspective", -3.0,
                  [[1.6, 0.0, 0.0], [0.0, 1.6, 0.0], [0.0, 0.0, 1.0]],
                  [0.1, 0.02, 0.0, 0.0, 0.0, 0.0, 0.001, 0.0]),
}


def _c2w(eye_z):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [0.1, 0.05, eye_z]
    return m


def _scene(kind, eye_z, K, dist):
    occluder = rt.make_shape(
        vertices=[[-0.6, -0.5, 0.0], [0.1, 0.6, 0.0], [0.7, -0.3, 0.0]],
        indices=[[0, 1, 2]], material_id=0)
    light = rt.make_shape(
        vertices=[[-1.2, -1.2, 1.0], [1.2, -1.2, 1.0], [-1.2, 1.2, 1.0],
                  [1.2, 1.2, 1.0]],
        indices=[[0, 1, 2], [1, 3, 2]], material_id=1, light_id=0)
    cam = rt.make_camera(cam_to_world=_c2w(eye_z), intrinsic_mat=K,
                         distortion_params=dist, fov=45.0,
                         camera_type=getattr(rt.CameraType, kind),
                         resolution=RES)
    return rt.make_scene(
        cam, [occluder, light],
        [rt.make_material(diffuse_reflectance=[0.1, 0.1, 0.1]),
         rt.make_material(diffuse_reflectance=[0.0, 0.0, 0.0])],
        area_lights=[rt.make_area_light(1, [4.0, 3.0, 2.0], two_sided=True)])


def _weight():
    return np.random.default_rng(2).uniform(0.5, 1.5, RES + (3,)).astype(
        np.float32)


def jax_reference(name):
    """(scene, image, gradients) of camera `name` through redner_tpu."""
    kind, eye_z, K, dist = CAMERAS[name]
    scene = _scene(kind, eye_z, K, dist)
    cam = scene.camera
    w = _weight()

    def loss(verts, c2w, k, d):
        c = rt.make_camera(cam_to_world=c2w, intrinsic_mat=k,
                           distortion_params=None if dist is None else d,
                           camera_type=cam.camera_type, resolution=RES)
        s = scene.replace(camera=c, shapes=(scene.shapes[0].replace(
            vertices=verts),) + scene.shapes[1:])
        img = rt.render(s, rt.RenderOptions(**OPTS), seed=SEED)
        return jnp.sum(img * w), img

    (_, img), grads = jax.value_and_grad(loss, (0, 1, 2, 3), has_aux=True)(
        scene.shapes[0].vertices, cam.cam_to_world, cam.intrinsic_mat,
        cam.distortion_params)
    return scene, np.asarray(img), [np.asarray(g) for g in grads]


def _check_camera(name):
    scene, img_ref, grads_ref = jax_reference(name)
    ts = port_scene(scene)
    cam = ts.camera
    assert not cam.use_look_at
    leaves = [ts.shapes[0].vertices, cam.cam_to_world, cam.intrinsic_mat,
              cam.distortion_params]
    for x in leaves:
        x.requires_grad_(True)
    img = rtt.render(ts, rtt.RenderOptions(**OPTS), seed=SEED)
    torch.sum(img * torch.as_tensor(_weight())).backward()
    np.testing.assert_allclose(img.detach().numpy(), img_ref, rtol=1e-4,
                               atol=1e-6)
    assert img_ref.max() > 0 and np.isfinite(img_ref).all()
    # Fisheye uses no intrinsic matrix; only the distorted camera uses
    # distortion_params.  An unused leaf gets no gradient here and zeros
    # in JAX.
    n_leaves = {"fisheye": 2, "orthographic": 3, "distorted": 4}[name]
    for i, (x, g) in enumerate(zip(leaves, grads_ref)):
        if i >= n_leaves:
            assert x.grad is None and not np.any(g), (name, i)
            continue
        got = x.grad.numpy()
        assert np.isfinite(got).all(), (name, i)
        assert np.abs(g).max() > 0, (name, i)
        np.testing.assert_allclose(got, g, rtol=1e-3,
                                   atol=1e-5 * np.abs(g).max(),
                                   err_msg=f"{name} leaf {i}")


def test_film_arc_cameras():
    """The fisheye and the distorted perspective camera: edges image to
    arcs."""
    for name in ("fisheye", "distorted"):
        _check_camera(name)


def test_orthographic_camera():
    """The viewpoint at infinity; the chord with the near-plane clip."""
    _check_camera("orthographic")
