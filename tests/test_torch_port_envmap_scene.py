"""The port's envmap-lit scene against redner_tpu on the CPU (split from
tests/test_torch_port_envmap.py so that its one JAX compile runs in a file
of its own).

tests/scene_util.envmap_scene (a triangle lit by the envmap alone, no area
light) rendered by both packages at a matched seed: image at rtol 1e-4
(atol 1e-5 x max), and rtt.render's edge-sampled gradient w.r.t. the
envmap texels, env_to_world, world_to_env and the vertices against
jax.grad of rt.render at rtol 1e-3 (atol 1e-5 x max), from one JAX
RenderOptions set."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from tests.scene_util import envmap_scene
from tests.test_torch_port_envmap import OPTS, SEED, _t
from tests.torch_port_util import (port_scene,  # noqa: F401
                                   two_torch_threads)


_LEAVES = (
    ("envmap texels", lambda s: s.envmap.values.texels),
    ("env_to_world", lambda s: s.envmap.env_to_world),
    ("world_to_env", lambda s: s.envmap.world_to_env),
    ("vertices", lambda s: s.shapes[0].vertices),
)


def _weight():
    return np.random.default_rng(0).uniform(0.5, 1.5, (8, 8, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def envmap_reference():
    """(JAX scene, image, gradients of sum(render * weight)) from the one
    JAX compile of this file."""
    scene = envmap_scene(res=(8, 8))
    w = _weight()

    def loss(p):
        env = scene.envmap
        env = env.replace(values=env.values.replace(texels=p[0]),
                          env_to_world=p[1], world_to_env=p[2])
        sc = scene.replace(envmap=env,
                           shapes=(scene.shapes[0].replace(vertices=p[3]),))
        img = rt.render(sc, rt.RenderOptions(**OPTS), seed=SEED)
        return jnp.sum(img * w), img

    params = tuple(get(scene) for _, get in _LEAVES)
    (_, img), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return scene, np.asarray(img), [np.asarray(g) for g in grads]


def test_envmap_scene_matches_jax(envmap_reference):
    scene, ref_img, ref_grads = envmap_reference
    ts = port_scene(scene)
    leaves = [get(ts) for _, get in _LEAVES]
    for x in leaves:
        x.requires_grad_(True)
    img = rtt.render(ts, rtt.RenderOptions(**OPTS), seed=SEED)
    np.testing.assert_allclose(img.detach().numpy(), ref_img, rtol=1e-4,
                               atol=1e-5 * ref_img.max())
    torch.sum(img * _t(_weight())).backward()
    for (name, _), x, r in zip(_LEAVES, leaves, ref_grads):
        g = x.grad.numpy()
        assert np.isfinite(g).all(), name
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(g, r, rtol=1e-3,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)
