"""The port's AOV channels against redner_tpu on the CPU: every channel
of a render and the full-channel gradient.

One scene (tests/torch_port_util.aov_scene) feeds every channel: uvs,
vertex colours, an image texture, a normal map, generic textures of five
and three channels, an area light and an envmap.  The JAX references are
one `rt.render_image` with all 16 channels and one edge-sampled gradient
of `rt.render` with all 16 channels at 0 bounces (C = 47, the Sobol
sampler, primary edges only: no secondary pass runs without a bounce),
both at 16x16, in this file of two tests (the lane's workers take it
after the files of many tests).  Float channels agree at rtol 1e-4 (atol
1e-5 x max), id channels exactly, gradients at rtol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redner_tpu as rt
import redner_tpu_torch as rtt
from redner_tpu_torch.channels import channel_dims
from tests.torch_port_util import (aov_scene, port_scene,  # noqa: F401
                                   two_torch_threads)

SEED = 5
RES = (16, 16)
ALL = tuple(rt.Channels)
C_ALL = 47
ID_CHANNELS = ("shape_id", "triangle_id", "material_id")
# Image: radiance with a bounce, the independent sampler, 2 spp, a camera
# that sees the envmap around the quad.  Gradient: the G-buffer defaults
# of render_g_buffer (Sobol, 0 bounces) at a camera the quad fills, so no
# camera ray misses (see test_depth_gradient_finite_where_rays_miss).
IMAGE_OPTS = dict(num_samples=2, max_bounces=1)
GRAD_OPTS = dict(num_samples=1, max_bounces=0)
GRAD_LEAVES = ("back vertices", "triangle vertices", "light vertices",
               "camera position", "diffuse texels", "generic texels")


def _jopts(**kw):
    return rt.RenderOptions(channels=ALL, **kw)


def _topts(**kw):
    return rtt.RenderOptions(channels=tuple(rtt.Channels), **kw)


def _weight():
    return np.random.default_rng(1).uniform(0.5, 1.5, RES + (C_ALL,)).astype(
        np.float32)


def _jax_gradient(scene, options, weight):
    """(image, gradients in GRAD_LEAVES order) of sum(render * weight)."""
    def image(p):
        verts, cam_pos, diffuse, generic = p
        m0 = scene.materials[0]
        m0 = m0.replace(
            diffuse_reflectance=m0.diffuse_reflectance.replace(texels=diffuse),
            generic_texture=m0.generic_texture.replace(texels=generic))
        sc = scene.replace(
            materials=(m0,) + tuple(scene.materials[1:]),
            shapes=tuple(s.replace(vertices=v)
                         for s, v in zip(scene.shapes, verts)),
            camera=scene.camera.replace(position=cam_pos))
        return rt.render(sc, options, seed=SEED)

    m0 = scene.materials[0]
    p = (tuple(s.vertices for s in scene.shapes), scene.camera.position,
         m0.diffuse_reflectance.texels, m0.generic_texture.texels)
    img, vjp = jax.vjp(image, p)
    (verts, cam_pos, diffuse, generic), = vjp(jnp.asarray(weight))
    return np.asarray(img), [np.asarray(g) for g in
                             (*verts, cam_pos, diffuse, generic)]


def _leaves(ts):
    m0 = ts.materials[0]
    return ([s.vertices for s in ts.shapes]
            + [ts.camera.position, m0.diffuse_reflectance.texels,
               m0.generic_texture.texels])


def _port_gradient(ts, options, weight):
    leaves = _leaves(ts)
    for x in leaves:
        x.requires_grad_(True)
    img = rtt.render(ts, options, seed=SEED)
    grads = torch.autograd.grad(torch.sum(img * torch.as_tensor(weight)),
                                leaves)
    for x in leaves:
        x.requires_grad_(False)
    return img.detach().numpy(), [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def refs():
    """The two JAX references and the port's counterparts."""
    scene = aov_scene(RES)
    close = aov_scene(RES, close=True)
    w = _weight()
    out = {"image": np.asarray(rt.render_image(scene, _jopts(**IMAGE_OPTS),
                                               seed=SEED))}
    out["g_image"], out["grads"] = _jax_gradient(
        close, _jopts(sampler_type=rt.SamplerType.sobol, **GRAD_OPTS), w)
    out["port_image"] = rtt.render_image(port_scene(scene),
                                         _topts(**IMAGE_OPTS),
                                         seed=SEED).numpy()
    out["port_g_image"], out["port_grads"] = _port_gradient(
        port_scene(close), _topts(sampler_type=rtt.SamplerType.sobol,
                                  **GRAD_OPTS), w)
    return out


def _check_channels(got, ref):
    ci = rtt.ChannelInfo(tuple(rtt.Channels))
    assert got.shape == ref.shape == RES + (C_ALL,)
    for ch, off in zip(ci.channels, ci.offsets):
        a = got[..., off:off + channel_dims(ch)]
        b = ref[..., off:off + channel_dims(ch)]
        if ch.name in ID_CHANNELS:
            # Ids are exact.  The port and intersect_pallas break an exact
            # tie in t toward the earlier Morton slot, intersect_mm (JAX's
            # CPU engine) toward the lower index (ROADMAP C); no ray of
            # this scene ties.
            np.testing.assert_array_equal(a, b, err_msg=ch.name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-5 * np.abs(b).max(),
                                       err_msg=ch.name)


def test_all_channels_match_reference(refs):
    """render_image with every channel, radiance with a bounce."""
    _check_channels(refs["port_image"], refs["image"])
    ci = rtt.ChannelInfo(tuple(rtt.Channels))
    img = refs["image"]
    # The scene feeds each channel: the envmap shows where rays miss, the
    # quad's five generic channels and the triangle's three are nonzero
    # and the rest of the 16 are zero-padded.
    alpha = img[..., ci.offset_of(rtt.Channels.alpha)]
    assert 0 < (alpha == 0).mean() < 0.5
    gen = img[..., ci.offset_of(rtt.Channels.generic_texture):][..., :16]
    assert np.abs(gen[..., :5]).max() > 0 and np.abs(gen[..., 5:]).max() == 0
    for ch in rtt.Channels:
        off = ci.offset_of(ch)
        assert np.abs(img[..., off:off + channel_dims(ch)]).max() > 0, ch.name


def test_full_channel_gradient_matches_jax(refs):
    """rtt.render under the G-buffer defaults (Sobol, 0 bounces): its
    forward, and its gradient under a weighted sum over all 47 channels
    w.r.t. every leaf of GRAD_LEAVES: the AD part and the primary-edge part
    with the full-channel adjoint and the Sobol edge draw."""
    _check_channels(refs["port_g_image"], refs["g_image"])
    for name, got, ref in zip(GRAD_LEAVES, refs["port_grads"], refs["grads"]):
        assert np.isfinite(got).all(), name
        if name != "light vertices":  # outside the view
            assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(got, ref, rtol=1e-3,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-30),
                                   err_msg=name)
