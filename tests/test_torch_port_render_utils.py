"""The port's render utilities on the CPU, the pieces against redner_tpu:
the four deferred lights alone (rtol 1e-5), the supersampling helpers,
spherical harmonics and sRGB (rtol 1e-6).  The whole renders against JAX
are in tests/test_torch_port_render_utils_jax.py (deferred, albedo) and
tests/test_torch_port_render_utils_trace.py (path tracing, generic)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu.render_utils as jru
import redner_tpu.utils as jutils
import redner_tpu_torch as rtt
from redner_tpu_torch import render_utils as tru
from tests.torch_port_util import (aov_scene, port_scene,  # noqa: F401
                                   two_torch_threads)

SEED = 3
RES = (8, 8)  # deferred renders its G-buffer at 16x16


def _lights(mod, pos):
    """Ambient, point (at `pos`), directional and spot lights of module
    `mod` (redner_tpu.render_utils or redner_tpu_torch.render_utils)."""
    return [
        mod.AmbientLight([0.05, 0.04, 0.03]),
        mod.PointLight(pos, [4.0, 3.5, 3.0]),
        mod.DirectionalLight([0.3, -0.5, 1.0], [0.8, 0.8, 0.9]),
        # redner_tpu's spot cone opens along spot_direction from the lit
        # point toward the light (cos = <spot_direction, d>, d toward the
        # light; ROADMAP C), so this spot at (0.5, 1, -2) lights the scene.
        mod.SpotLight([0.5, 1.0, -2.0], [0.2, 0.4, -1.0], 4.0,
                      [2.0, 2.0, 2.0]),
    ]


POINT = np.asarray([0.4, 0.6, -2.5], np.float32)


def test_deferred_lights_match_jax():
    """Each light's shading of a random G-buffer, alone."""
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (64, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    alb = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    for jl, tl in zip(_lights(jru, POINT), _lights(tru, POINT)):
        ref = np.asarray(jl.render(pos, nrm, alb))
        got = tl.render(*(torch.as_tensor(x) for x in (pos, nrm, alb)))
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7)


def test_upscaled_camera_and_downsample():
    ts = port_scene(aov_scene(RES))
    cam = dataclasses.replace(ts.camera, viewport=(2, 1, 6, 7))
    up = tru._upscaled_camera(cam, 3)
    assert up.resolution == (24, 24) and up.viewport == (6, 3, 18, 21)
    assert tru._upscaled_camera(cam, 1) is cam
    img = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    ref = np.asarray(jru._area_downsample(jnp.asarray(img.numpy()), 2))
    np.testing.assert_array_equal(tru._area_downsample(img, 2).numpy(), ref)


def _close_sum(got, ref):
    """rtol 1e-6; the atol of 1e-6 x max covers the two einsums'
    float32 summation orders where the terms cancel."""
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("order", [0, 2, 4])
def test_sh_matches_jax(order):
    rng = np.random.default_rng(order)
    d = rng.normal(0, 1, (128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = (order + 1) ** 2
    _close_sum(rtt.sh_basis(order, torch.as_tensor(d)).numpy(),
               np.asarray(jutils.sh_basis(order, jnp.asarray(d))))
    for shape in ((n,), (n, 3)):
        c = rng.normal(0, 1, shape).astype(np.float32)
        _close_sum(rtt.sh_eval(torch.as_tensor(c), torch.as_tensor(d)).numpy(),
                   np.asarray(jutils.sh_eval(jnp.asarray(c), jnp.asarray(d))))
    c = rng.normal(0, 1, (n, 3)).astype(np.float32)
    got = rtt.sh_reconstruct(torch.as_tensor(c), (16, 8))
    assert got.shape == (8, 16, 3)
    _close_sum(got.numpy(),
               np.asarray(jutils.sh_reconstruct(jnp.asarray(c), (16, 8))))
    with pytest.raises(ValueError):
        rtt.sh_eval(torch.zeros(5), torch.as_tensor(d))


def test_srgb_matches_jax():
    x = np.linspace(-0.1, 1.2, 1001, dtype=np.float32)
    for fj, ft in ((jutils.srgb_to_linear, rtt.srgb_to_linear),
                   (jutils.linear_to_srgb, rtt.linear_to_srgb)):
        np.testing.assert_allclose(ft(torch.as_tensor(x)).numpy(),
                                   np.asarray(fj(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-7)
    y = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    back = rtt.srgb_to_linear(rtt.linear_to_srgb(torch.as_tensor(y)))
    np.testing.assert_allclose(back.numpy(), y, rtol=1e-4, atol=1e-6)
