"""The port's TorchRenderer (redner_tpu_torch.torch_bridge), the JAX
package's bridge class (tests/test_torch_bridge.py) on the port: its image
and gradients are rtt.render's on the same scene, bit for bit on one
thread; the gradient lands on the parameter's device; a forward keeps only
the re-render's inputs, so two forwards before one backward hold no
residual of the first."""

import dataclasses

import torch

import redner_tpu_torch as rtt
from redner_tpu_torch.scene import scene_tensors
from tests.torch_port_spawn import single_triangle
from tests.torch_port_util import one_thread  # noqa: F401
from tests.torch_port_util import two_torch_threads  # noqa: F401

OPTIONS = dict(num_samples=2, max_bounces=1)


def setter(template, verts, intensity):
    """The triangle's vertices and the light's intensity into the scene."""
    tri = dataclasses.replace(template.shapes[0], vertices=verts)
    light = dataclasses.replace(template.area_lights[0], intensity=intensity)
    return dataclasses.replace(template, shapes=(tri,) + template.shapes[1:],
                               area_lights=(light,))


def _params(scene):
    return (scene.shapes[0].vertices.clone().requires_grad_(True),
            scene.area_lights[0].intensity.clone().requires_grad_(True))


def test_image_and_gradients_equal_render(one_thread):  # noqa: F811
    scene = single_triangle(res=(8, 8))
    opts = rtt.RenderOptions(**OPTIONS)
    params = _params(scene)
    img = rtt.TorchRenderer(opts, setter, seed=3)(scene, *params)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    got = torch.autograd.grad(torch.sum(img * img), params)

    ref_params = _params(scene)
    ref = rtt.render(setter(scene, *ref_params), opts, seed=3)
    want = torch.autograd.grad(torch.sum(ref * ref), ref_params)
    assert torch.equal(img, ref)
    for g, w in zip(got, want):
        assert float(w.abs().max()) > 0
        assert torch.equal(g, w)


def test_gradient_on_the_parameters_device():
    scene = single_triangle(res=(8, 8))
    verts, intensity = _params(scene)
    render = rtt.TorchRenderer(rtt.RenderOptions(**OPTIONS), setter)
    img = render.render(scene, verts, intensity)
    assert img.device == verts.device
    img.sum().backward()
    for p in (verts, intensity):
        assert p.grad is not None and p.grad.device == p.device
        assert bool(torch.isfinite(p.grad).all())


def test_two_forwards_before_one_backward_keep_no_residuals(
        one_thread):  # noqa: F811
    """Each forward saves the seed and the scene's tensors, nothing of the
    render's work; a backward through both sums their gradients."""
    scene = single_triangle(res=(8, 8))
    render = rtt.TorchRenderer(rtt.RenderOptions(**OPTIONS), setter)
    params = _params(scene)
    imgs = [render(scene, *params) for _ in range(2)]
    inputs = scene_tensors(setter(scene, *params))
    for img in imgs:
        saved = img.grad_fn.saved_tensors
        assert len(saved) == 1 + len(inputs)
        assert sum(t.numel() for t in saved) == 1 + sum(
            t.numel() for t in inputs)
    (one,) = torch.autograd.grad(imgs[0].sum(), params[0],
                                 retain_graph=True)
    (two,) = torch.autograd.grad(imgs[0].sum() + imgs[1].sum(), params[0])
    assert torch.equal(two, one + one)
