"""The port's screen gradient against redner_tpu on the CPU.

screen_gradient_image takes two forward-mode derivatives of the per-pixel
render w.r.t. the pixel jitter (torch.autograd.forward_ad where JAX takes
jax.jvp) and, with primary edges on, scatters the primary-edge samples'
jumps into their pixels.  Both, on shadow_scene at 16x16 with the
radiance and alpha channels, against redner_tpu.screen_gradient at rtol
1e-3 (atol 1e-5 x max), in a file of two tests (the lane's workers take
it after the files of many)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu.edge import primary_edge_screen_gradient_image
from redner_tpu.render import render_sample as j_render_sample
from redner_tpu.scene import flatten_scene as j_flatten
from redner_tpu.screen_gradient import screen_gradient_image as j_sg
from tests.scene_util import shadow_scene
from tests.torch_port_util import port_scene, two_torch_threads  # noqa: F401

SEED = 3
KW = dict(num_samples=2, max_bounces=1)


def _opts(mod, edges):
    return mod.RenderOptions(
        channels=(mod.Channels.radiance, mod.Channels.alpha),
        use_primary_edge_sampling=edges, **KW)


@pytest.fixture(scope="module")
def pair():
    """(port, JAX) images without and with primary edges.  JAX's with-edge
    image is its continuous image plus primary_edge_screen_gradient_image
    (what redner_tpu.screen_gradient_image adds when the option is on),
    taken from the continuous call here to pay its compile once."""
    scene = shadow_scene(res=(16, 16))
    ts = port_scene(scene)
    cont = np.asarray(j_sg(scene, _opts(rt, False), seed=SEED))
    edge = np.asarray(primary_edge_screen_gradient_image(
        scene, j_flatten, j_render_sample, _opts(rt, True), jnp.uint32(SEED),
        16 * 16 * KW["num_samples"], cont.shape))
    return {edges: (rtt.screen_gradient_image(ts, _opts(rtt, edges),
                                              seed=SEED).numpy(), ref)
            for edges, ref in ((False, cont), (True, cont + edge))}


def _check(got, ref):
    assert got.shape == (16, 16, 2, 4)
    assert np.isfinite(got).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-3,
                               atol=1e-5 * np.abs(ref).max())


def test_screen_gradient_matches_jax(pair):
    """Without primary edges: the forward-mode part alone.  Alpha is
    piecewise constant, so it has none; visualize_screen_gradient is the
    norm of the first channel's two derivatives."""
    got, ref = pair[False]
    _check(got, ref)
    assert np.abs(got[..., 3]).max() == 0
    ts = port_scene(shadow_scene(res=(16, 16)))
    v = rtt.visualize_screen_gradient(ts, _opts(rtt, False), seed=SEED)
    torch.testing.assert_close(
        v, torch.linalg.norm(torch.as_tensor(got)[..., 0], dim=-1),
        rtol=0.0, atol=0.0)


def test_screen_gradient_with_primary_edges_matches_jax(pair):
    """With primary edges: the edge samples add the silhouettes' jumps,
    the only screen derivative alpha has."""
    got, ref = pair[True]
    _check(got, ref)
    cont, _ = pair[False]
    assert np.abs(got[..., 3]).max() > 0
    assert np.abs(got[..., :3] - cont[..., :3]).max() > 0
