"""Second derivatives through the port's render and render_image against
JAX's reverse over reverse (jax.grad of jax.grad), on the CPU at matched
seeds: the verify skill's one-triangle scene, 8x8, 2 spp, 1 bounce, seed
0; h = d/dv sum(d/dv sum(image^2)) w.r.t. the triangle's vertices.

JAX differentiates render's custom_vjp bwd through the residual scene and
the cotangent, and the forward's image as plain code, so the image that
the first gradient depends on carries no edge terms; the port does the
same (render_grad._backward).

render_image's reference is computed here (one JAX second derivative,
~70 s cold).  render's costs ~3-4 minutes cold at any scene size (the
second derivative of the edge-sampled backward), so the fast lane holds
the port against JAX's values recorded from that computation at this
scene (JAX_RENDER_H), and the `slow` test recomputes them live and checks
the recording."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import redner_tpu_torch as rtt
from redner_tpu_torch.parallel.sharding import make_mesh
from tests.torch_port_spawn import single_triangle
from tests.torch_port_util import two_torch_threads  # noqa: F401

RES = (8, 8)
DIFFUSE = (0.5, 0.4, 0.3)
SAMPLERS = {"both": (True, True), "primary": (True, False),
            "secondary": (False, True)}
# jax.grad(lambda v: jnp.sum(jax.grad(lambda v: jnp.sum(rt.render(
# scene(v), options, 0) ** 2))(v)))(v) at this scene, per edge sampler
# (test_render_second_derivative_matches_jax_live computes them again).
JAX_RENDER_H = {
    "both": [[0.06436941772699356, -0.09892457723617554, 0.12728656828403473],
             [-0.07328646630048752, -0.11641942709684372, 0.36734074354171753],
             [0.026375744491815567, 0.05949724093079567,
              -0.06674739718437195]],
    "primary": [[0.06436941772699356, -0.09892458468675613,
                 0.12730784714221954],
                [-0.07328646630048752, -0.11641942709684372,
                 0.36704814434051514],
                [0.026375744491815567, 0.05949724465608597,
                 -0.0665915310382843]],
    "secondary": [[4.326631497519884e-09, -2.7273294733731746e-08,
                   0.0785006731748581],
                  [-4.326631497519884e-09, 2.2207209404712103e-09,
                   0.48116427659988403],
                  [0.0, 2.5052576901885004e-08, -0.1816944032907486]],
}


def _options(jax_module, samplers="both", **kw):
    primary, secondary = SAMPLERS[samplers]
    return jax_module.RenderOptions(
        num_samples=2, max_bounces=1, use_primary_edge_sampling=primary,
        use_secondary_edge_sampling=secondary, **kw)


def _jax_h(fn, samplers="both"):
    """JAX's second derivative of fn (rt.render or rt.render_image)."""
    import jax
    import jax.numpy as jnp

    import redner_tpu as rt

    scene = rt.make_scene(
        rt.make_camera(position=[0.0, 0.0, -5.0], look_at=[0.0, 0.0, 0.0],
                       up=[0.0, 1.0, 0.0], fov=45.0, resolution=RES),
        [rt.make_shape(vertices=[[-1.7, 1.0, 0.0], [1.0, 1.0, 0.0],
                                 [-0.5, -1.0, 0.0]], indices=[[0, 1, 2]]),
         rt.make_shape(vertices=[[-1.0, -1.0, -7.0], [1.0, -1.0, -7.0],
                                 [-1.0, 1.0, -7.0], [1.0, 1.0, -7.0]],
                       indices=[[0, 1, 2], [1, 3, 2]], light_id=0)],
        [rt.make_material(diffuse_reflectance=list(DIFFUSE))],
        [rt.make_area_light(1, [20.0, 20.0, 20.0])])
    opts = _options(rt, samplers)

    def with_vertices(v):
        return scene.replace(shapes=(scene.shapes[0].replace(vertices=v),)
                             + tuple(scene.shapes[1:]))

    def g(v):
        return jax.grad(lambda v: jnp.sum(
            fn(with_vertices(v), opts, 0) ** 2))(v)

    return np.asarray(jax.grad(lambda v: jnp.sum(g(v)))(
        scene.shapes[0].vertices))


def port_h(fn, samplers="both", remat=False):
    """The port's second derivative of fn at the same scene and seed; the
    first gradient must carry history."""
    scene = single_triangle(RES, DIFFUSE)
    v = scene.shapes[0].vertices.requires_grad_(True)
    img = fn(scene, _options(rtt, samplers, remat=remat), seed=0)
    (g,) = torch.autograd.grad(torch.sum(img ** 2), v, create_graph=True)
    assert g.requires_grad
    (h,) = torch.autograd.grad(torch.sum(g), v)
    return h.numpy()


@pytest.fixture(scope="module")
def jax_image_h():
    import redner_tpu as rt

    return _jax_h(rt.render_image)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("remat", [False, True])
def test_render_image_second_derivative_matches_jax(jax_image_h, remat):
    """render_image has no edge terms: the port's autograd twice equals
    jax.grad twice, with and without remat (torch.utils.checkpoint,
    non-reentrant, carries the second derivative)."""
    _close(port_h(rtt.render_image, remat=remat), jax_image_h)


@pytest.mark.parametrize("samplers,remat", [
    ("both", False), ("both", True), ("primary", False),
    ("secondary", False)])
def test_render_second_derivative_matches_jax(samplers, remat):
    """render's second derivative, both edge samplers and each alone,
    against JAX's recorded values."""
    _close(port_h(rtt.render, samplers, remat),
           np.asarray(JAX_RENDER_H[samplers]))


@pytest.mark.slow
@pytest.mark.parametrize("samplers", list(SAMPLERS))
def test_render_second_derivative_matches_jax_live(samplers):
    """JAX's second derivative of render computed here (~3-4 minutes
    cold each): it equals the recorded values, and the port equals it."""
    import redner_tpu as rt

    want = _jax_h(rt.render, samplers)
    _close(np.asarray(JAX_RENDER_H[samplers]), want)
    _close(port_h(rtt.render, samplers), want)


def test_first_order_backward_is_unchanged():
    """Without create_graph the backward detaches as before: the gradient
    has no history and equals the one of a recording backward."""
    scene = single_triangle(RES, DIFFUSE)
    v = scene.shapes[0].vertices.requires_grad_(True)
    opts = _options(rtt)
    (g,) = torch.autograd.grad(torch.sum(rtt.render(scene, opts, 0) ** 2), v)
    assert not g.requires_grad
    (g2,) = torch.autograd.grad(torch.sum(rtt.render(scene, opts, 0) ** 2),
                                v, create_graph=True)
    torch.testing.assert_close(g, g2.detach(), rtol=1e-6, atol=1e-9)


def test_first_order_backward_after_a_recording_one_is_edge_sampled():
    """The continuous backward belongs only to the pass that
    differentiates a recorded gradient: after grad(..., create_graph=True,
    retain_graph=True) and that pass, a plain loss.backward() through the
    same render gives the edge-sampled first-order gradient, and the
    second derivative is the one of a fresh render."""
    scene = single_triangle(RES, DIFFUSE)
    v = scene.shapes[0].vertices.requires_grad_(True)
    opts = _options(rtt)
    (want,) = torch.autograd.grad(
        torch.sum(rtt.render(scene, opts, 0) ** 2), v)
    loss = torch.sum(rtt.render(scene, opts, 0) ** 2)
    (g,) = torch.autograd.grad(loss, v, create_graph=True, retain_graph=True)
    (h,) = torch.autograd.grad(torch.sum(g), v, retain_graph=True)
    loss.backward()
    torch.testing.assert_close(v.grad, want, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(g.detach(), want, rtol=1e-6, atol=1e-9)
    _close(h.numpy(), np.asarray(JAX_RENDER_H["both"]))


@pytest.fixture
def gloo_world(tmp_path):
    """A gloo process group of one rank in this process: a pixel sharding
    with collectives."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield make_mesh("cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("name", ["render", "render_image"])
def test_second_derivative_under_pixel_sharding_raises(gloo_world, name):
    """A sharded gradient is all-reduced over the ranks, which is not
    differentiable: create_graph raises NotImplementedError where a
    first-order result would be silently wrong."""
    scene = single_triangle(RES, DIFFUSE)
    v = scene.shapes[0].vertices.requires_grad_(True)
    img = getattr(rtt, name)(scene, _options(rtt), seed=0,
                             pixel_sharding=gloo_world)
    with pytest.raises(NotImplementedError, match="pixel sharding"):
        torch.autograd.grad(torch.sum(img ** 2), v, create_graph=True)
