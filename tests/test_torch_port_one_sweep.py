"""RenderOptions(split_shadow_sweep=False) is accepted and changes nothing:
against redner_tpu's single closest-hit sweep under the same option (image
rtol 1e-4, edge-sampled gradients rtol 1e-3), against the port's default,
and its launch pattern, the default's."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu_torch import edge as tedge
from redner_tpu_torch.ops import intersect_cuda as ic
from tests.scene_util import shadow_scene
from tests.torch_port_util import (port_scene, shadow_grads_port,  # noqa: F401
                                   two_torch_threads)

trender = importlib.import_module("redner_tpu_torch.render")
SEED = 5
OPTIONS = dict(num_samples=2, max_bounces=1)


def _weight(res):
    return np.random.default_rng(1).uniform(
        0.5, 1.5, res + (3,)).astype(np.float32)


def _jax_image_and_grads(scene, options, seed, weight):
    """redner_tpu.render's image and jax.grad of sum(image * weight) w.r.t.
    the diffuse, the light intensity, every shape's vertices and the camera
    position, from one trace."""

    def loss(params):
        diffuse, intensity, verts, cam_pos = params
        mat = scene.materials[0]
        mat = mat.replace(diffuse_reflectance=mat.diffuse_reflectance.replace(
            texels=diffuse))
        sc = scene.replace(
            materials=(mat,),
            area_lights=(scene.area_lights[0].replace(intensity=intensity),),
            shapes=tuple(s.replace(vertices=v)
                         for s, v in zip(scene.shapes, verts)),
            camera=scene.camera.replace(position=cam_pos))
        img = rt.render(sc, options, seed=seed)
        return jnp.sum(img * weight), img

    params = (scene.materials[0].diffuse_reflectance.texels,
              scene.area_lights[0].intensity,
              tuple(s.vertices for s in scene.shapes), scene.camera.position)
    (_, img), (g_d, g_i, g_v, g_p) = jax.value_and_grad(
        loss, has_aux=True)(params)
    return np.asarray(img), [np.asarray(g_d), np.asarray(g_i),
                             *(np.asarray(g) for g in g_v), np.asarray(g_p)]


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-5 * np.abs(ref).max())


def test_one_sweep_matches_jax():
    res = (8, 8)
    scene = shadow_scene(res=res)
    weight = _weight(res)
    ref_img, ref_grads = _jax_image_and_grads(
        scene, rt.RenderOptions(split_shadow_sweep=False, **OPTIONS), SEED,
        weight)
    img, grads = shadow_grads_port(
        port_scene(scene),
        rtt.RenderOptions(split_shadow_sweep=False, **OPTIONS), SEED, weight)
    _close(img.numpy(), ref_img, 1e-4)
    assert np.abs(ref_grads[2]).max() > 0  # the floor's vertices
    for got, ref in zip(grads, ref_grads):
        _close(got, ref, 1e-3)


@pytest.mark.parametrize("max_bounces", [1, 2])
def test_one_sweep_matches_the_split_path(max_bounces):
    res = (16, 16)
    tscene = port_scene(shadow_scene(res=res))
    weight = _weight(res)
    opts = dict(num_samples=2, max_bounces=max_bounces)
    img_s, grads_s = shadow_grads_port(
        tscene, rtt.RenderOptions(**opts), SEED, weight)
    img_1, grads_1 = shadow_grads_port(
        tscene, rtt.RenderOptions(split_shadow_sweep=False, **opts), SEED,
        weight)
    assert float(img_s.max()) > 0
    torch.testing.assert_close(img_1, img_s, rtol=1e-6, atol=0.0)
    for got, ref in zip(grads_1, grads_s):
        _close(got, ref, 1e-4)


@pytest.mark.parametrize("split,forward,gradient", [
    (True, (8, 4), (32, 16)),
    (False, (8, 4), (32, 16)),
], ids=["split", "one_sweep"])
def test_launches(monkeypatch, split, forward, gradient):
    """Launches of a 16x16, 4 spp forward and gradient, with the kernel
    wrappers counted as on the card: four passes of 256 lanes and four
    primary-edge chunks of 512 pair rays; with the option off, shadow rays
    still go through the any-hit kernel."""
    monkeypatch.setattr(trender, "SAMPLES_LANE_TARGET", 256)
    monkeypatch.setattr(tedge, "EDGE_EVAL_CHUNK", 512)
    counts = {"closest_hit": 0, "any_hit": 0}
    wrappers = {"closest_hit": ic.closest_hit, "any_hit": ic.any_hit}

    def counting(kind):
        def run(lay, rb):
            counts[kind] += 1
            return wrappers[kind](lay, rb)
        return run

    monkeypatch.setattr(ic, "closest_hit", counting("closest_hit"))
    monkeypatch.setattr(ic, "any_hit", counting("any_hit"))
    tscene = port_scene(shadow_scene(res=(16, 16)))
    opts = rtt.RenderOptions(num_samples=4, max_bounces=1,
                             split_shadow_sweep=split)
    with torch.no_grad():
        rtt.render_image(tscene, opts, seed=SEED)
    assert (counts["closest_hit"], counts["any_hit"]) == forward
    counts.update(closest_hit=0, any_hit=0)
    shadow_grads_port(tscene, opts, SEED, _weight((16, 16)))
    assert (counts["closest_hit"], counts["any_hit"]) == gradient
