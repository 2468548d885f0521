"""The port's render_pathtracing against redner_tpu on the CPU, with the
Sobol sampler: the image at rtol 1e-4 (atol 1e-5 x max) and its gradient
at rtol 1e-3.  Radiance and alpha with one bounce: the product path with
both edge samplers.  One test and one JAX compile (the lane's workers take
a file of few tests after the files of many); render_generic is in
tests/test_torch_port_render_utils_generic.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu.render_utils as jru
import redner_tpu_torch as rtt
from tests.scene_util import shadow_scene
from tests.torch_port_util import port_scene, two_torch_threads  # noqa: F401

SEED = 9
RES = (8, 8)
PT_LEAVES = ("diffuse", "light intensity", "blocker vertices")


def _close(got, ref, rtol):
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-5 * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def pathtracing():
    """render_pathtracing(alpha=True, 1 bounce, Sobol, 2 spp) and its
    gradient w.r.t. the diffuse reflectance, the light intensity and the
    blocker's vertices."""
    scene = shadow_scene(res=RES)
    w = np.random.default_rng(0).uniform(0.5, 1.5, RES + (4,)).astype(
        np.float32)

    def image(p):
        diffuse, intensity, verts = p
        m0 = scene.materials[0]
        m0 = m0.replace(diffuse_reflectance=m0.diffuse_reflectance.replace(
            texels=diffuse))
        sc = scene.replace(
            materials=(m0,) + tuple(scene.materials[1:]),
            area_lights=(scene.area_lights[0].replace(intensity=intensity),),
            shapes=(scene.shapes[0], scene.shapes[1].replace(vertices=verts),
                    *scene.shapes[2:]))
        return jru.render_pathtracing(sc, alpha=True, num_samples=2,
                                      seed=SEED)

    p = (scene.materials[0].diffuse_reflectance.texels,
         scene.area_lights[0].intensity, scene.shapes[1].vertices)

    # The image and its vjp in one jitted program: one compile, ~6% less
    # than jax.vjp's separate forward and backward compiles.
    @jax.jit
    def image_and_vjp(p):
        ref, vjp = jax.vjp(image, p)
        return ref, vjp(jnp.asarray(w))[0]

    ref, gref = image_and_vjp(p)
    ts = port_scene(scene)
    leaves = [ts.materials[0].diffuse_reflectance.texels,
              ts.area_lights[0].intensity, ts.shapes[1].vertices]
    for x in leaves:
        x.requires_grad_(True)
    got = rtt.render_pathtracing(ts, alpha=True, num_samples=2, seed=SEED)
    g = torch.autograd.grad(torch.sum(got * torch.as_tensor(w)), leaves)
    return (np.asarray(ref), [np.asarray(x) for x in gref],
            got.detach().numpy(), [x.numpy() for x in g])


def test_pathtracing_matches_jax(pathtracing):
    """The image and its gradient w.r.t. PT_LEAVES."""
    ref, gref, got, g = pathtracing
    assert got.shape == RES + (4,) and ref[..., :3].max() > 0
    _close(got, ref, 1e-4)
    for name, x, r in zip(PT_LEAVES, g, gref):
        assert np.abs(r).max() > 0, name
        _close(x, r, 1e-3)
