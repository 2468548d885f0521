"""The port's render_deferred and render_albedo against redner_tpu on the
CPU.

render_deferred (the four light kinds, alpha, 2x2 supersampling) and
render_albedo (a list of two scenes) run through rtt.render with the
Sobol sampler, as the reference's do: outputs at rtol 1e-4 and one
gradient each at rtol 1e-3 (primary edges only, no radiance), from one
module-scoped JAX reference per entry point, in this file of two tests
(the lane's workers take it after the files of many tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu.render_utils as jru
import redner_tpu_torch as rtt
from redner_tpu_torch import render_utils as tru
from tests.test_torch_port_render_utils import POINT, RES, SEED, _lights
from tests.torch_port_util import (aov_scene, port_scene,  # noqa: F401
                                   two_torch_threads)

DEFERRED_LEAVES = ("back vertices", "triangle vertices", "diffuse texels",
                   "point light position")


def _replace_leaves(scene, verts, diffuse):
    m0 = scene.materials[0]
    m0 = m0.replace(diffuse_reflectance=m0.diffuse_reflectance.replace(
        texels=diffuse))
    return scene.replace(
        materials=(m0,) + tuple(scene.materials[1:]),
        shapes=(scene.shapes[0].replace(vertices=verts[0]),
                scene.shapes[1].replace(vertices=verts[1]),
                *scene.shapes[2:]))


def _port_leaves(ts):
    return [ts.shapes[0].vertices, ts.shapes[1].vertices,
            ts.materials[0].diffuse_reflectance.texels]


@pytest.fixture(scope="module")
def deferred():
    scene = aov_scene(RES)
    w = np.random.default_rng(0).uniform(0.5, 1.5, RES + (4,)).astype(
        np.float32)

    def image(p):
        verts, diffuse, pos = p
        return jru.render_deferred(_replace_leaves(scene, verts, diffuse),
                                   _lights(jru, pos), alpha=True,
                                   aa_samples=2, seed=SEED)

    p = ((scene.shapes[0].vertices, scene.shapes[1].vertices),
         scene.materials[0].diffuse_reflectance.texels, jnp.asarray(POINT))
    ref, vjp = jax.vjp(image, p)
    (gv, gd, gp), = vjp(jnp.asarray(w))
    ts = port_scene(scene)
    pos = torch.as_tensor(POINT)
    leaves = _port_leaves(ts) + [pos]
    for x in leaves:
        x.requires_grad_(True)
    got = rtt.render_deferred(ts, _lights(tru, pos), alpha=True,
                              aa_samples=2, seed=SEED)
    grads = torch.autograd.grad(torch.sum(got * torch.as_tensor(w)), leaves)
    return (np.asarray(ref), [np.asarray(g) for g in (*gv, gd, gp)],
            got.detach().numpy(), [g.numpy() for g in grads])


def _close(got, ref, rtol):
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-5 * max(np.abs(ref).max(), 1e-30))


def test_deferred_matches_jax(deferred):
    """The image and its gradient w.r.t. DEFERRED_LEAVES."""
    ref, gref, got, ggot = deferred
    assert got.shape == RES + (4,)
    alpha = ref[..., 3]
    assert np.abs(ref[..., :3]).max() > 0 and 0 < alpha.mean() < 1
    _close(got, ref, 1e-4)
    for name, g, r in zip(DEFERRED_LEAVES, ggot, gref):
        assert np.abs(r).max() > 0, name
        _close(g, r, 1e-3)


@pytest.fixture(scope="module")
def albedo():
    """render_albedo on a list of two scenes (the second with its camera
    moved), 2 spp: the stack and the gradient w.r.t. the first scene's
    diffuse texels."""
    a = aov_scene(RES)
    b = a.replace(camera=a.camera.replace(
        position=jnp.asarray([0.3, 0.2, -3.5], jnp.float32)))
    w = np.random.default_rng(2).uniform(0.5, 1.5, (2,) + RES + (3,)).astype(
        np.float32)

    def stack(diffuse):
        m0 = a.materials[0]
        m0 = m0.replace(diffuse_reflectance=m0.diffuse_reflectance.replace(
            texels=diffuse))
        sa = a.replace(materials=(m0,) + tuple(a.materials[1:]))
        return jru.render_albedo([sa, b], num_samples=2, seed=SEED)

    ref, vjp = jax.vjp(stack, a.materials[0].diffuse_reflectance.texels)
    gref, = vjp(jnp.asarray(w))
    ta, tb = port_scene(a), port_scene(b)
    tex = ta.materials[0].diffuse_reflectance.texels.requires_grad_(True)
    got = rtt.render_albedo([ta, tb], num_samples=2, seed=SEED)
    g, = torch.autograd.grad(torch.sum(got * torch.as_tensor(w)), tex)
    return np.asarray(ref), np.asarray(gref), got.detach().numpy(), g.numpy()


def test_albedo_list_matches_jax(albedo):
    """The stack of two scenes and the gradient w.r.t. the first scene's
    diffuse texels."""
    ref, gref, got, g = albedo
    assert got.shape == (2,) + RES + (3,)
    assert not np.allclose(ref[0], ref[1])
    _close(got, ref, 1e-4)
    assert np.abs(gref).max() > 0
    _close(g, gref, 1e-3)
