"""redner_tpu_torch.compat (pyredner names: the torch front end's, re-
exported) against redner_tpu.compat, and the package surface the port
gained with it: the device and timing helpers and the pyredner-style
namespaces.

tests/test_compat.py's reference-style script runs on the port with
`.backward()` in place of jax.grad; its image equals redner_tpu.compat's at
the same seed (rtol 1e-4; one JAX forward compile)."""

import json
import os

import numpy as np
import pytest
import torch

import redner_tpu_torch as rtt
import redner_tpu_torch.compat as pyredner
import redner_tpu_torch.frontend as frontend
from tests.torch_port_util import (cpu_default_device,  # noqa: F401
                                   one_thread, two_torch_threads)


def _script_scene(pr, light_kw=()):
    """tests/test_compat.py's scene through compat module `pr`.  light_kw:
    redner_tpu.compat's Shape takes the light's id (light_id=0); pyredner's
    and the front end's take it from AreaLight's shape_id."""
    cam = pr.Camera(position=[0.0, 0.0, -5.0], look_at=[0.0, 0.0, 0.0],
                    up=[0.0, 1.0, 0.0], fov=45.0, resolution=(16, 16))
    mat_grey = pr.Material(diffuse_reflectance=[0.5, 0.5, 0.5])
    shape_triangle = pr.Shape(
        vertices=[[-1.7, 1.0, 0.0], [1.0, 1.0, 0.0], [-0.5, -1.0, 0.0]],
        indices=[[0, 1, 2]], material_id=0)
    shape_light = pr.Shape(
        vertices=[[-1.0, -1.0, -7.0], [1.0, -1.0, -7.0], [-1.0, 1.0, -7.0],
                  [1.0, 1.0, -7.0]],
        indices=[[0, 1, 2], [1, 3, 2]], material_id=0, **dict(light_kw))
    light = pr.AreaLight(1, [20.0, 20.0, 20.0])
    return pr.Scene(camera=cam, shapes=[shape_triangle, shape_light],
                    materials=[mat_grey], area_lights=[light])


@pytest.fixture(scope="module")
def jax_image():
    import redner_tpu.compat as jcompat

    scene = _script_scene(jcompat, light_kw={"light_id": 0})
    args = jcompat.serialize_scene(scene=scene, num_samples=4, max_bounces=1)
    return np.asarray(jcompat.RenderFunction.apply(0, args))


def test_reference_style_script(cpu_default_device, one_thread, jax_image):
    scene = _script_scene(pyredner)
    scene_args = pyredner.serialize_scene(scene=scene, num_samples=4,
                                          max_bounces=1)
    verts = scene.shapes[0].vertices.requires_grad_(True)
    # redner_tpu.compat's one-argument form; pyredner's is apply(0, *args).
    img = pyredner.RenderFunction.apply(0, scene_args)
    assert img.shape == (16, 16, 3)
    assert bool(torch.isfinite(img).all()) and float(img.detach().sum()) > 0
    np.testing.assert_allclose(img.detach().numpy(), jax_image, rtol=1e-4,
                               atol=1e-6)
    # Gradients through the shim: .backward() on the user's tensors.
    img.sum().backward()
    assert verts.grad is not None and bool(torch.isfinite(verts.grad).all())
    assert float(verts.grad.abs().max()) > 0
    g = verts.grad.clone()
    verts.grad = None
    pyredner.render(scene, num_samples=4, max_bounces=1, seed=0).sum() \
        .backward()
    assert torch.equal(verts.grad, g)


def test_compat_utilities_present():
    for name in [
        "load_obj", "save_obj", "load_mitsuba", "imread", "imwrite",
        "compute_vertex_normal", "compute_uvs", "smooth",
        "generate_sphere", "generate_quad_light",
        "automatic_camera_placement", "generate_intrinsic_mat",
        "set_print_timing", "set_use_correlated_random_number",
        "visualize_screen_gradient", "render_deferred", "render_albedo",
        "render_pathtracing", "render_g_buffer", "render_generic",
        "AmbientLight", "PointLight", "DirectionalLight", "SpotLight",
        "set_device", "get_device", "camera_type", "channels",
    ]:
        assert hasattr(pyredner, name), name
    for name in ["DeferredLight", "FlatScene", "camera_type", "channels",
                 "profile_trace", "timed", "set_print_timing",
                 "get_print_timing", "set_device", "get_device", "use_gpu",
                 "Intersection", "Ray", "RayDifferential", "SurfacePoint"]:
        assert hasattr(rtt, name), name
    assert rtt.camera_type.fisheye is rtt.CameraType.fisheye
    assert rtt.channels.triangle_id is rtt.Channels.triangle_id
    assert issubclass(rtt.PointLight, rtt.DeferredLight)


def test_compat_is_the_front_end():
    """One pyredner surface: compat re-exports the front end's names."""
    for name in frontend.__all__:
        assert getattr(pyredner, name) is getattr(frontend, name), name
    for name in ("Camera", "Shape", "Scene", "serialize_scene",
                 "RenderFunction", "render"):
        assert name in frontend.__all__


def test_visualize_screen_gradient_takes_a_front_end_scene(
        cpu_default_device):
    scene = _script_scene(pyredner)
    img = pyredner.visualize_screen_gradient(scene, seed=0, num_samples=2)
    assert img.shape == (16, 16)
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0
    assert torch.equal(img, rtt.visualize_screen_gradient(
        scene._build(), rtt.RenderOptions(num_samples=2), seed=0))


def test_namespaces_match_redner_tpu():
    """The pyredner-style namespaces name the same members as
    redner_tpu's, with the port's own enums behind them."""
    import redner_tpu as rt

    for ours, theirs in ((rtt.camera_type, rt.camera_type),
                         (rtt.channels, rt.channels)):
        names = sorted(k for k in vars(theirs) if not k.startswith("_"))
        assert sorted(k for k in vars(ours) if not k.startswith("_")) == names
        for k in names:
            assert getattr(ours, k).name == getattr(theirs, k).name
            assert getattr(ours, k).value == getattr(theirs, k).value
            assert type(getattr(ours, k)).__module__.startswith(
                "redner_tpu_torch")


def test_set_device_is_the_default_of_entry_points(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rtt.set_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        rtt.get_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        pyredner.Material(diffuse_reflectance=[0.5, 0.5, 0.5])
    assert rtt.use_gpu() is False
    try:
        rtt.set_device("cpu")
        assert rtt.get_device() == torch.device("cpu")
        m = pyredner.Material(diffuse_reflectance=[0.5, 0.5, 0.5])
        assert m.diffuse_reflectance.texels.device.type == "cpu"
        # An explicit device still wins.
        assert rtt.resolve_device("cpu") == torch.device("cpu")
        rtt.set_device(1)
        with pytest.raises(RuntimeError, match="CUDA"):
            rtt.get_device()
    finally:
        rtt.set_device(None)


def test_timed_prints_only_when_asked(capsys):
    with rtt.timed("quiet"):
        pass
    assert capsys.readouterr().out == ""
    rtt.set_print_timing(True)
    try:
        with rtt.timed("loud"):
            pass
    finally:
        rtt.set_print_timing(False)
    assert capsys.readouterr().out.startswith("loud: ")


def test_profile_trace_writes_a_chrome_trace(cpu_default_device, tmp_path):
    scene = _script_scene(pyredner)
    with rtt.profile_trace(str(tmp_path / "trace")) as prof:
        rtt.render_image(scene._build(), rtt.RenderOptions(num_samples=1),
                         seed=0)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert len(events) > 0
    assert len(prof.key_averages()) > 0
