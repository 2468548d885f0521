"""The port's render_generic against redner_tpu on the CPU, with the Sobol
sampler: AOVs only (depth, the generic texture, vertex colours, shape ids)
at the pixel centres, so the backward runs primary edges alone.  The
image at rtol 1e-4 (atol 1e-5 x max; shape ids exactly) and its gradient
at rtol 1e-3.  One test and one JAX compile (the lane's workers take a
file of few tests after the files of many)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu.render_utils as jru
import redner_tpu_torch as rtt
from tests.test_torch_port_render_utils_trace import RES, SEED, _close
from tests.torch_port_util import (aov_scene, port_scene,  # noqa: F401
                                   two_torch_threads)

GENERIC_CHANNELS = ("depth", "generic_texture", "vertex_color", "shape_id")
GENERIC_LEAVES = ("back vertices", "generic texels")


@pytest.fixture(scope="module")
def generic():
    scene = aov_scene(RES)
    jch = [rt.Channels[c] for c in GENERIC_CHANNELS]
    tch = [rtt.Channels[c] for c in GENERIC_CHANNELS]
    C = rtt.ChannelInfo(tch).num_total_dimensions
    w = np.random.default_rng(1).uniform(0.5, 1.5, RES + (C,)).astype(
        np.float32)

    def image(p):
        verts, gen = p
        m0 = scene.materials[0]
        m0 = m0.replace(generic_texture=m0.generic_texture.replace(
            texels=gen))
        sc = scene.replace(
            materials=(m0,) + tuple(scene.materials[1:]),
            shapes=(scene.shapes[0].replace(vertices=verts),
                    *scene.shapes[1:]))
        return jru.render_generic(sc, jch, num_samples=2,
                                  sample_pixel_center=True, seed=SEED)

    p = (scene.shapes[0].vertices, scene.materials[0].generic_texture.texels)
    ref, vjp = jax.vjp(image, p)
    gref = vjp(jnp.asarray(w))[0]
    ts = port_scene(scene)
    leaves = [ts.shapes[0].vertices, ts.materials[0].generic_texture.texels]
    for x in leaves:
        x.requires_grad_(True)
    got = rtt.render_generic(ts, tch, num_samples=2,
                             sample_pixel_center=True, seed=SEED)
    g = torch.autograd.grad(torch.sum(got * torch.as_tensor(w)), leaves)
    return (np.asarray(ref), [np.asarray(x) for x in gref],
            got.detach().numpy(), [x.numpy() for x in g])


def test_generic_matches_jax(generic):
    """The AOVs (shape ids exactly) and the gradient w.r.t.
    GENERIC_LEAVES."""
    ref, gref, got, g = generic
    assert got.shape == RES + (1 + 16 + 3 + 1,)
    np.testing.assert_array_equal(got[..., -1], ref[..., -1])  # shape ids
    _close(got, ref, 1e-4)
    for name, x, r in zip(GENERIC_LEAVES, g, gref):
        assert np.abs(r).max() > 0, name
        _close(x, r, 1e-3)
