"""The port's textured, normal-mapped scene against redner_tpu on the CPU
(split from tests/test_torch_port_textures.py, whose scene builder it
uses, so that its one JAX compile runs in a file of its own).

A quad with a non-power-of-two diffuse texture, a roughness texture and a
normal map, under an envmap and an area light, rendered by both packages
at a matched seed: image at rtol 1e-4 (atol 1e-5 x max), and rtt.render's
gradient against jax.grad of rt.render at rtol 1e-3 (atol 1e-5 x max)
from one JAX RenderOptions set."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu_torch.scene import flatten_scene
from tests.test_torch_port_textures import (OPTS, SEED, _t,
                                            _textured_quad_scene)
from tests.torch_port_util import (port_scene,  # noqa: F401
                                   two_torch_threads)


def _weight(res):
    return np.random.default_rng(0).uniform(0.5, 1.5, res + (3,)).astype(
        np.float32)


# (name, getter on a Scene of either package)
_LEAVES = (
    ("quad vertices", lambda s: s.shapes[0].vertices),
    ("diffuse texels", lambda s: s.materials[0].diffuse_reflectance.texels),
    ("roughness texels", lambda s: s.materials[0].roughness.texels),
    ("normal map texels", lambda s: s.materials[0].normal_map.texels),
    ("envmap texels", lambda s: s.envmap.values.texels),
    ("env_to_world", lambda s: s.envmap.env_to_world),
    ("world_to_env", lambda s: s.envmap.world_to_env),
)


def _with_jax_leaves(scene, p):
    mat = scene.materials[0]
    mat = mat.replace(
        diffuse_reflectance=mat.diffuse_reflectance.replace(texels=p[1]),
        roughness=mat.roughness.replace(texels=p[2]),
        normal_map=mat.normal_map.replace(texels=p[3]))
    env = scene.envmap
    env = env.replace(values=env.values.replace(texels=p[4]),
                      env_to_world=p[5], world_to_env=p[6])
    return scene.replace(
        shapes=(scene.shapes[0].replace(vertices=p[0]),) + scene.shapes[1:],
        materials=(mat,) + scene.materials[1:], envmap=env)


@pytest.fixture(scope="module")
def quad_reference():
    """(JAX scene, image, gradients of sum(render * weight)) from the one
    JAX compile of this file."""
    scene = _textured_quad_scene()
    w = _weight((8, 8))

    def loss(p):
        img = rt.render(_with_jax_leaves(scene, p), rt.RenderOptions(**OPTS),
                        seed=SEED)
        return jnp.sum(img * w), img

    params = tuple(get(scene) for _, get in _LEAVES)
    (_, img), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return scene, np.asarray(img), [np.asarray(g) for g in grads]


def test_textured_scene_matches_jax(quad_reference):
    scene, ref_img, ref_grads = quad_reference
    ts = port_scene(scene)
    fs = flatten_scene(ts)
    assert fs.has_envmap and fs.num_lights == 2 and fs.mat_bank is not None
    leaves = [get(ts) for _, get in _LEAVES]
    for x in leaves:
        x.requires_grad_(True)
    img = rtt.render(ts, rtt.RenderOptions(**OPTS), seed=SEED)
    np.testing.assert_allclose(img.detach().numpy(), ref_img, rtol=1e-4,
                               atol=1e-5 * ref_img.max())
    torch.sum(img * _t(_weight((8, 8)))).backward()
    for (name, _), x, r in zip(_LEAVES, leaves, ref_grads):
        g = x.grad.numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=1e-3,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)
    assert np.abs(ref_grads[1]).max() > 0 and np.abs(ref_grads[4]).max() > 0
