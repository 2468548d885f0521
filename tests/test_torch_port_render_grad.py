"""redner_tpu_torch.render (edge-sampled gradients) against redner_tpu.render
on the CPU.

shadow_scene at 16x16, 1 bounce, rendered by both packages at a matched
seed; the loss is a fixed weighted image sum, so its gradient is the
backward's alone.  Gradients w.r.t. the diffuse reflectance, the light
intensity, every vertex and the camera position agree at rtol 1e-3, atol
1e-5 x max.  Each JAX option set costs a ~40 s compile here, so the
secondary-only and (2, 4)-sample cases run from
test_torch_port_render_grad_options.py, on another worker."""

import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from tests.scene_util import shadow_scene
from tests.torch_port_util import (port_scene, shadow_grads_jax,  # noqa: F401
                                   shadow_grads_port, two_torch_threads)

U32_MAX = 2**32 - 1
TWO_SPP = dict(num_samples=2, max_bounces=1)


# name -> (RenderOptions keywords, seed, correlated replay)
CASES = {
    "both_samplers": (TWO_SPP, 7, True),
    "primary_only": (dict(TWO_SPP, use_secondary_edge_sampling=False), 7, True),
    "secondary_only": (dict(TWO_SPP, use_primary_edge_sampling=False), 7, True),
    "decorrelated": (TWO_SPP, U32_MAX, False),
    "spp_2_4": (dict(num_samples=(2, 4), max_bounces=1), 7, True),
    "seed_u32_max": (TWO_SPP, U32_MAX, True),
}


def _weight():
    return np.random.default_rng(0).uniform(0.5, 1.5, (16, 16, 3)).astype(
        np.float32)


def check_render_gradients(case):
    kw, seed, correlated = CASES[case]
    scene = shadow_scene(res=(16, 16))
    w = _weight()
    # The backward depends on the forward only through its seed, and the
    # decorrelated backward re-renders at seed + 1 (mod 2^32): JAX's
    # decorrelated gradient at seed s is its correlated one at s + 1.
    jseed = seed if correlated else (seed + 1) & U32_MAX
    ref = shadow_grads_jax(scene, rt.RenderOptions(**kw), jseed, w)

    keep = rtt.get_use_correlated_random_number()
    rtt.set_use_correlated_random_number(correlated)
    try:
        img, got = shadow_grads_port(port_scene(scene),
                                     rtt.RenderOptions(**kw), seed, w)
    finally:
        rtt.set_use_correlated_random_number(keep)
    assert img.shape == (16, 16, 3)
    names = ["diffuse", "intensity", "floor", "blocker", "light", "cam_pos"]
    for name, g, r in zip(names, got, ref):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=1e-3,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)
    assert np.abs(ref[3]).max() > 0  # the blocker moves the shadow


@pytest.mark.parametrize("case", ["both_samplers", "primary_only",
                                  "decorrelated", "seed_u32_max"])
def test_render_gradients_match_jax(case):
    check_render_gradients(case)


def test_forward_is_render_image():
    """render's forward is render_image, bit for bit; the correlated flag
    is read when render is called."""
    ts = port_scene(shadow_scene(res=(16, 16)))
    opts = rtt.RenderOptions(**TWO_SPP)
    ref = rtt.render_image(ts, opts, seed=U32_MAX)
    assert torch.equal(rtt.render(ts, opts, seed=U32_MAX), ref)
    assert torch.equal(rtt.render(ts, opts, seed=-1), ref)  # wraps to u32
    assert rtt.get_use_correlated_random_number()


def test_default_device_needs_a_card():
    """Entry points default to the card: without one the scene cannot be
    built, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        rtt.make_camera(position=[0, 0, -5], look_at=[0, 0, 0], up=[0, 1, 0],
                        fov=45.0, resolution=(4, 4))
